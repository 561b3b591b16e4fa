"""Port parity, the serving twins: ``examples/torch_serve_f2p_kv.py`` and
``examples/torch_serve_continuous.py`` against their references
(``examples/serve_f2p_kv.py``, ``examples/serve_continuous.py``) computed
in-process through ``repro.serve`` on the CPU, with the reference's
weights and prompts carried across (``models.convert.params_from_jax``).

Held EQUAL, as the reference's own acceptance and reports:
- ``serve_f2p_kv``: the cache bytes of both runs (the reference printed
  0.79 / 0.22 MB: at 8 bits the port's packed cache costs exactly the
  reference's unpacked bytes), every generated token of both runs, and the
  exact-vs-F2P8 agreement;
- ``serve_continuous``: every request's tokens (the port's paged run
  against the reference's batched engine), the three-way bitwise equality
  inside the port (the twin asserts it on the CPU), a validated trace, and
  the pool's packed and logical-f32 KB and peak pages.
Greedy tokens are the parity oracle for the model's f32 logits, which
agree within 1e-4 (``tests/test_torch_model.py``).
"""
import _torch_threads  # noqa: F401
import jax
import numpy as np
import torch
from _examples import load_twin

from repro.configs import smoke_config as jsmoke
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import dense_pattern as jdense_pattern
from repro.serve import BatchedEngine as JBatchedEngine
from repro.serve import BatchedServeConfig as JBatchedServeConfig
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import smoke_config
from repro_torch.models.convert import params_from_jax

CPU = torch.device("cpu")


def test_serve_f2p_kv_twin_matches_reference(capsys):
    twin = load_twin("torch_serve_f2p_kv")
    cfg = twin.demo_config()
    jcfg = JModelConfig(name="serve-demo", n_layers=4, d_model=256,
                        n_heads=8, n_kv_heads=4, d_ff=512, vocab_size=1024,
                        pattern=jdense_pattern(), dtype="float32",
                        remat=False)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(7))
    B, S, new = 4, 32, 16
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                            jcfg.vocab_size))
    want, want_bytes = {}, {}
    for quant in (False, True):
        scfg = JServeConfig(batch=B, max_seq=S + new, quantized_kv=quant)
        want[quant] = JEngine(jcfg, scfg, jparams).generate(prompts, new)
        cache = jinit_caches(jcfg, B, S + new, quantized_kv=quant)
        want_bytes[quant] = sum(x.size * x.dtype.itemsize
                                for x in jax.tree.leaves(cache))

    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    res = twin.serve_demo(CPU, model=model, prompts=prompts)
    out = capsys.readouterr().out
    for quant in (False, True):
        np.testing.assert_array_equal(res["tokens"][quant], want[quant])
        assert res["cache_mb"][quant] * 1e6 == want_bytes[quant]
        assert (f"quantized_kv={quant}: cache={want_bytes[quant]/1e6:.2f} "
                f"MB, first row: {want[quant][0][:8].tolist()}") in out
    assert f"{want_bytes[False]/1e6:.2f}" == "0.79"
    assert f"{want_bytes[True]/1e6:.2f}" == "0.22"
    agree = (want[True] == want[False]).mean()
    assert res["agreement"] == agree
    assert f"token agreement exact-vs-F2P8: {agree:.2%}" in out


def test_serve_continuous_twin_matches_reference(tmp_path, capsys):
    twin = load_twin("torch_serve_continuous")
    jcfg = jsmoke("llama3_2_3b")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    cfg = smoke_config("llama3_2_3b")
    reqs = twin.make_requests(cfg.vocab_size)
    jreqs = [JRequest(uid=r.uid, tokens=r.tokens, max_new=r.max_new,
                      arrival=r.arrival) for r in reqs]
    jeng = JBatchedEngine(jcfg, JBatchedServeConfig(slots=4, max_seq=64),
                          jparams)
    want = jeng.run(jreqs)
    jpool = jeng.stats["pool"]

    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    trace = tmp_path / "serve.trace.json"
    res = twin.serve_continuous(CPU, model=model, trace=str(trace))
    out = capsys.readouterr().out
    # the twin asserted paged == copy-in == sequential on the CPU
    assert ("12 requests bit-for-bit identical to the copy-in engine AND "
            "the sequential engine") in out
    assert res["sequential_agree"] == res["n_requests"] == 12
    for r in reqs:
        np.testing.assert_array_equal(res["paged"][r.uid], want[r.uid],
                                      err_msg=f"request {r.uid}")
        np.testing.assert_array_equal(res["sequential"][r.uid], want[r.uid])
    assert res["tokens"] == sum(len(v) for v in want.values())
    assert res["pool_kb_packed"] == jpool["pool_bytes_packed"] / 1e3
    assert res["pool_kb_logical_f32"] == jpool["pool_bytes_logical_f32"] / 1e3
    assert (res["peak_pages"], res["n_pages"]) == (jpool["peak_used"],
                                                   jpool["n_pages"])
    assert res["trace_events"] and trace.exists()
    assert "trace OK  :" in out and "12 request rows" in out

