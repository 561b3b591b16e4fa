"""Port parity, serve layer: ``repro_torch.serve`` against the JAX reference.

On the 12-request staggered workload of ``examples/serve_continuous.py``
(smoke llama3.2-3b, f32, reference weights via ``params_from_jax``), the
port's BatchedEngine — paged and copy-in — gives the same per-request
greedy tokens as the JAX sequential Engine; inside the port paged ==
copy-in == sequential token for token; preempt -> evict -> readmit and pool
defragmentation leave the tokens unchanged; temperature draws do not
change with the co-scheduled set; and the package imports with ``jax`` and
``repro`` blocked.
"""
import subprocess
import sys
from pathlib import Path

import _torch_threads  # noqa: F401
import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import init_params as jinit_params
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import smoke_config
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import (BatchedEngine, BatchedServeConfig, Engine,
                               Request, ServeConfig)

CPU = torch.device("cpu")
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke("llama3_2_3b")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    cfg = smoke_config("llama3_2_3b")
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jcfg, jparams, cfg, model


def _continuous_workload(cfg):
    """The request queue of examples/serve_continuous.py."""
    rng = np.random.default_rng(42)
    return [Request(uid=u + 1,
                    tokens=rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(4, 25))
                                        ).astype(np.int32),
                    max_new=int(rng.integers(8, 25)),
                    arrival=3 * u)
            for u in range(12)]


def _port_sequential(cfg, model, reqs, max_seq):
    eng = Engine(cfg, ServeConfig(batch=1, max_seq=max_seq, quantized_kv=True,
                                  fused_attention=True), model)
    return {r.uid: eng.generate(r.tokens[None], r.max_new)[0].astype(np.int32)
            for r in reqs}


def test_batched_engines_match_jax_sequential_engine(setup):
    jcfg, jparams, cfg, model = setup
    reqs = _continuous_workload(cfg)
    bs = dict(slots=4, max_seq=64)
    paged = BatchedEngine(cfg, BatchedServeConfig(**bs), model)
    out = paged.run(reqs)
    copy_in = BatchedEngine(cfg, BatchedServeConfig(paged_decode=False, **bs),
                            model).run(reqs)
    seq = _port_sequential(cfg, model, reqs, 64)
    jeng = JEngine(jcfg, JServeConfig(batch=1, max_seq=64, quantized_kv=True,
                                      packed_kv=True, fused_attention=True),
                   jparams)
    for r in reqs:
        want = np.asarray(jeng.generate(r.tokens[None], r.max_new)[0],
                          np.int32)
        np.testing.assert_array_equal(out[r.uid], want)
        np.testing.assert_array_equal(copy_in[r.uid], out[r.uid])
        np.testing.assert_array_equal(seq[r.uid], out[r.uid])
    assert paged.stats["prefills"] == len(reqs)
    assert paged.stats["pool"]["used"] == paged.stats["reserved_pages"] == 1
    assert paged.stats["emitted_tokens"] == sum(r.max_new for r in reqs)


def test_unfused_sequential_engine_matches_jax(setup):
    """The port's Engine at its default fused_attention=False (each decode
    step reads every layer's whole K and V cache back through
    ``f2p_kv_read``) gives the JAX unfused packed Engine's greedy tokens on
    4 requests of the continuous workload."""
    jcfg, jparams, cfg, model = setup
    reqs = _continuous_workload(cfg)[:4]
    eng = Engine(cfg, ServeConfig(batch=1, max_seq=64, quantized_kv=True),
                 model)
    jeng = JEngine(jcfg, JServeConfig(batch=1, max_seq=64, quantized_kv=True,
                                      packed_kv=True, fused_attention=False),
                   jparams)
    for r in reqs:
        got = eng.generate(r.tokens[None], r.max_new)[0]
        want = np.asarray(jeng.generate(r.tokens[None], r.max_new)[0])
        np.testing.assert_array_equal(got.astype(np.int32),
                                      want.astype(np.int32))


def _long_requests(cfg, n=5):
    rng = np.random.default_rng(7)
    return [Request(uid=u + 1,
                    tokens=rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(3, 13))
                                        ).astype(np.int32),
                    max_new=16)
            for u in range(n)]


@pytest.mark.parametrize("paged", [True, False])
def test_preempt_evict_readmit_matches_uninterrupted(setup, paged):
    """Starvation preempts the longest-tail slot, evicts its KV to host
    numpy and readmits it later: the tokens equal an uninterrupted run."""
    _, _, cfg, model = setup
    reqs = _long_requests(cfg)
    eng = BatchedEngine(cfg, BatchedServeConfig(slots=2, max_seq=32,
                                                sync_every=4,
                                                preempt_patience=1,
                                                paged_decode=paged), model)
    out = eng.run(reqs)
    for key in ("preemptions", "host_evictions", "readmits"):
        assert eng.stats.get(key, 0) > 0, key
    seq = _port_sequential(cfg, model, reqs, 32)
    for r in reqs:
        np.testing.assert_array_equal(out[r.uid], seq[r.uid])


def test_defrag_relocate_and_fifo_keep_tokens(setup):
    """Pool compaction every round, a mid-decode page relocation and the
    FIFO scheduler are all bitwise invisible in the tokens."""
    _, _, cfg, model = setup
    reqs = _long_requests(cfg, 4)
    base = BatchedEngine(cfg, BatchedServeConfig(slots=3, max_seq=32),
                         model).run(reqs)
    eng = BatchedEngine(cfg, BatchedServeConfig(slots=3, max_seq=32,
                                                defrag_every=1,
                                                scheduler="fifo",
                                                io_upload="full"), model)
    grow = eng._grow_tables

    def grow_then_relocate():
        need = grow()
        for s in range(3):
            eng.relocate_slot(s)
        return need

    eng._grow_tables = grow_then_relocate
    out = eng.run(reqs)
    for r in reqs:
        np.testing.assert_array_equal(out[r.uid], base[r.uid])
    assert eng.stats["pool"]["used"] == 1


def test_temperature_draws_independent_of_coscheduling(setup):
    _, _, cfg, model = setup
    bs = dict(slots=3, max_seq=32, temperature=0.8, seed=5)
    target = Request(uid=41, tokens=np.arange(7, dtype=np.int32), max_new=8)
    alone = BatchedEngine(cfg, BatchedServeConfig(**bs), model).run([target])
    rng = np.random.default_rng(9)
    crowd = [Request(uid=u + 1, tokens=rng.integers(0, cfg.vocab_size, 5),
                     max_new=8) for u in range(4)]
    co = BatchedEngine(cfg, BatchedServeConfig(**bs), model).run(
        crowd + [target])
    np.testing.assert_array_equal(alone[41], co[41])
    greedy = BatchedEngine(cfg, BatchedServeConfig(slots=3, max_seq=32),
                           model).run([target])
    assert not np.array_equal(greedy[41], alone[41])


def test_sequential_engine_partial_batch_and_periodic_eos(setup):
    """A partial batch pads to the configured batch and slices the pad rows
    off (rows equal the full-batch run); with EOS on, decoding stops at the
    first all-done sync point and every row's tokens up to its EOS agree."""
    _, _, cfg, model = setup
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (3, 6)).astype(np.int32)
    full = Engine(cfg, ServeConfig(batch=3, max_seq=32, quantized_kv=True,
                                   fused_attention=True), model)
    want = full.generate(prompts, 10)
    part = Engine(cfg, ServeConfig(batch=4, max_seq=32, quantized_kv=True,
                                   fused_attention=True), model)
    np.testing.assert_array_equal(part.generate(prompts[:2], 10), want[:2])
    eos = int(want[0, 2])
    got = Engine(cfg, ServeConfig(batch=1, max_seq=32, quantized_kv=True,
                                  fused_attention=True, eos_sync_every=2),
                 model).generate(prompts[:1], 10, eos=eos)
    # token 2 is the EOS; it comes from decode step 2, a sync point
    assert got.shape[1] == 3
    np.testing.assert_array_equal(got[0], want[0, :3])


_HYGIENE = """
import importlib, pkgutil, sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, _Block())
for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]:
    del sys.modules[m]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
print(" ".join(names))
print(len(names))
"""


def test_import_hygiene_no_jax_no_reference():
    proc = subprocess.run([sys.executable, "-c", _HYGIENE],
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    *names, count = proc.stdout.split()
    assert int(count) >= 60
    for sub in ("sketch", "obs", "telemetry", "autotune", "optim", "train",
                "launch", "data", "faults", "kernels.f2p_matmul",
                "autotune.calibrate", "fl", "fl.exact", "fl.rounds",
                "faults.plan"):
        assert f"repro_torch.{sub}" in names, sub


EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TWINS = sorted(EXAMPLES.glob("torch_*.py"))

_TWIN_HYGIENE = """
import importlib.util, sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, _Block())
for path in sys.argv[1:]:
    name = path.rsplit("/", 1)[-1][:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
print(len(sys.argv) - 1)
"""


def test_example_twins_import_no_jax_no_reference():
    """Every ``examples/torch_*.py`` loads with ``jax`` and ``repro``
    blocked, and no import statement in it (a function's lazy import
    included) names either."""
    import ast

    names = sorted(p.stem for p in TWINS)
    assert names == ["torch_autotune_study", "torch_counters_telemetry",
                     "torch_fed_avg", "torch_quickstart",
                     "torch_serve_continuous", "torch_serve_f2p_kv",
                     "torch_sketch_zipf_trace"]
    proc = subprocess.run([sys.executable, "-c", _TWIN_HYGIENE,
                           *map(str, TWINS)],
                          env={"PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) == len(TWINS)
    for path in TWINS:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    (path.name, m)
