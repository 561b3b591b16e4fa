"""Port parity, the counter twins: ``examples/torch_counters_telemetry.py``
and ``examples/torch_sketch_zipf_trace.py`` against their references
(``examples/counters_telemetry.py``, ``examples/sketch_zipf_trace.py``)
computed in-process on the CPU.

- ``counters_telemetry`` is host numpy in both packages (the copied
  ``core.counters`` and the obs ``ExpertLoadTracker``): its whole report is
  held to the reference's, TEXT for text.
- The sketch twin at 2^16 packets over 2^20 flows, twice (the reference's
  geometry: 4 x 4096 12-bit LI^2 cells, batches of 2^16, 128 candidates).
  The port's advance spends a batch's budget in 16-sweep launches and
  carries the rest to the next batch under a fresh numpy seed (C4), while
  the reference's xla backend spends it all on one ``jax.random`` stream,
  so the two trajectories are equal only in distribution. Two runs:
  (1) the twin as it ships: the same top-10 key SET, the same recall and
  the same register KiB; (2) the twin's ingest loop over a port sketch
  whose advance replays the reference's per-update seeds through
  ``counter_advance_exact`` (the reference's stream, chunk by chunk): the
  same ranked keys and recall, and every estimate within 1% relative. Not
  bitwise, because torch's and XLA's CPU ``log`` differ by one ulp on a
  few inputs, which moves ``ceil(log u / log q)`` in a few draws per
  million (C3, ``tests/test_torch_sketch.py``) and so a cell by a grid
  step here and there.
"""
import contextlib
import io

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _examples import EXAMPLES, load_reference, load_twin

from repro.serve.engine import SketchIngestEngine as JEngine
from repro.sketch import F2PSketch as JSketch
from repro.sketch import SketchConfig as JConfig
from repro_torch.kernels import f2p_counter as FC
from repro_torch.sketch import F2PSketch, SketchConfig

CPU = torch.device("cpu")
N_PACKETS, N_FLOWS = 1 << 16, 1 << 20


def test_counters_telemetry_report_is_the_reference_text():
    ref = load_reference("counters_telemetry")
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        ref.shootout()
        ref.expert_loads()
    got = io.StringIO()
    with contextlib.redirect_stdout(got):
        rc = load_twin("torch_counters_telemetry").main(["--device", "cpu"])
    assert rc == 0
    assert got.getvalue() == want.getvalue()
    # the reference's number, not its docstring's "~1%"
    assert "mean rel err: 15.12% (8-bit registers, range 130048)" in \
        got.getvalue()


def _reference_sketch_run(trace: np.ndarray) -> dict:
    """sketch_zipf_trace.py's loop through the reference's API."""
    sk = JSketch(JConfig(depth=4, width=4096, n_bits=12, h_bits=2,
                         flavor="li", backend="xla"))
    eng = JEngine(sk, batch=1 << 16, track_top=128)
    rng = np.random.default_rng(1)
    for _ in range(2):
        pos = 0
        while pos < len(trace):
            n = int(rng.integers(10_000, 90_000))
            eng.ingest(trace[pos:pos + n])
            pos += n
        eng.flush()
    rep = eng.heavy_hitters(10)
    return {"keys": [int(k) for k in rep.keys],
            "estimates": [float(e) for e in rep.estimates],
            "register_kib": sk.nbytes / 1024}


class ReplayedSketch(F2PSketch):
    """The port's sketch advancing on the reference's stream: each update's
    whole budget on one exact run seeded as the reference's xla backend
    seeds it (``jax.random.split`` of the config's key, then 32 bits)."""

    def __init__(self, cfg, device):
        super().__init__(cfg, device=device)
        self._key = jax.random.PRNGKey(cfg.seed)

    def _advance(self, budget):
        self._key, sub = jax.random.split(self._key)
        seed = int(jax.random.bits(sub, (), jnp.uint32))
        self.state, self._carry = FC.counter_advance_exact(
            self.state, budget, self._p_lut, self._run_lut, self._logq_lut,
            seed)


@pytest.fixture(scope="module")
def sketch_runs():
    twin = load_twin("torch_sketch_zipf_trace")
    want = _reference_sketch_run(twin.make_trace(N_PACKETS, N_FLOWS))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        shipped = twin.sketch_demo(CPU, n_packets=N_PACKETS, n_flows=N_FLOWS)
        cfg = SketchConfig(depth=4, width=4096, n_bits=12, h_bits=2,
                           flavor="li")
        replayed = twin.sketch_demo(CPU, n_packets=N_PACKETS,
                                    n_flows=N_FLOWS,
                                    sketch=ReplayedSketch(cfg, CPU))
    return want, shipped, replayed, out.getvalue()


def test_sketch_twin_as_shipped_finds_the_reference_top10(sketch_runs):
    want, shipped, _, out = sketch_runs
    assert set(shipped["keys"]) == set(want["keys"])
    assert shipped["recall"] == 1.0
    assert shipped["register_kib"] == want["register_kib"] == 32.0
    assert "top-10 recall: 100%" in out and "device=cpu" in out
    assert "= 32 KiB of registers" in out


def test_sketch_twin_on_the_reference_stream_within_1pct(sketch_runs):
    want, _, replayed, _ = sketch_runs
    assert replayed["keys"] == want["keys"]
    assert replayed["recall"] == 1.0
    np.testing.assert_allclose(replayed["estimates"], want["estimates"],
                               rtol=1e-2)


TWINS = sorted(p.stem for p in EXAMPLES.glob("torch_*.py"))


@pytest.mark.parametrize("name", TWINS)
def test_example_twins_refuse_a_missing_cuda_device(name):
    """Every twin defaults to ``--device cuda`` and, with no CUDA device,
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    twin = load_twin(name)
    with pytest.raises(RuntimeError, match="--device cpu"):
        twin.main([])
