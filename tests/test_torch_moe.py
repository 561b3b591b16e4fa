"""Port parity, MoE layer: ``repro_torch.models.moe`` against the JAX
reference's ``repro.models.moe`` on smoke llama4-scout (f32), the reference's
weights carried over by ``params_from_jax``.

* ``moe_apply``'s output within rtol = atol = 1e-5, its expert picks and
  ``load`` equal and its ``aux_loss`` within 1e-6 relative (an f32 mean
  taken in another order), at the smoke capacity and at a low one where
  capacity drops assignments; with two experts per token too (the combine
  then adds each token's parts in the reference's order).
* A router tie goes to the lower expert index, as ``lax.top_k``.
* The capacity is Python's banker's ``round`` of the reference's host
  arithmetic.
* ``train_forward``'s total, ``ce_loss`` and ``aux_loss`` within 1e-5.
* Serving: the port's ``BatchedEngine`` gives the reference
  ``BatchedEngine``'s tokens (``scheduler="fifo"``) on one staggered
  workload, paged and copy-in: scout smoke, and maverick smoke under a
  different KV format per attention position. On the scout workload the
  reference's own paged and copy-in runs differ (and the port's with
  them): idle slots are routed and take capacity, and they read other KV
  in the two modes.
"""
import dataclasses

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.autotune.policy import FormatPolicy as JPolicy
from repro.configs import smoke_config as jax_smoke
from repro.models import init_params as jinit_params
from repro.models import moe as JMOE
from repro.models import train_forward as jtrain_forward
from repro.serve import BatchedEngine as JBatched
from repro.serve import BatchedServeConfig as JBatchedConfig
from repro.serve import Request as JRequest
from repro_torch.autotune import FormatPolicy
from repro_torch.configs import smoke_config
from repro_torch.core.formats import named_format
from repro_torch.models import moe as MOE
from repro_torch.models import train_forward
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import BatchedEngine, BatchedServeConfig, Request

CPU = torch.device("cpu")
ARCH = "llama4_scout_17b"


def _pair(arch=ARCH, **over):
    """(JAX cfg, JAX params, port cfg, port model) of a smoke config with
    ``over`` replaced in both configs."""
    jcfg = dataclasses.replace(jax_smoke(arch), **over)
    cfg = dataclasses.replace(smoke_config(arch), **over)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module")
def scout():
    return _pair()


def _x(cfg, B=3, S=8, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _jax_layer(jparams, g=0):
    """Group ``g``'s MoE leaves of the reference's stacked b0 block."""
    return jax.tree.map(lambda a: a[g], jparams["blocks"]["b0"]["ff"])


def _check_layer(jcfg, jparams, cfg, model, x, layer=0):
    jp = _jax_layer(jparams, layer)
    jout, jaux = JMOE.moe_apply(jp, jnp.asarray(x), jcfg)
    out, aux = MOE.moe_apply(model.blocks[layer].ff, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(aux["load"].numpy(),
                                  np.asarray(jaux["load"]))
    # an f32 mean over the tokens, summed in another order than XLA's
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(jaux["aux_loss"]), rtol=1e-6, atol=0)
    # the expert picks: top-k of the f32 router's softmax
    xf = x.reshape(-1, cfg.d_model)
    jprobs = jax.nn.softmax(jnp.asarray(xf) @ jp["router"], axis=-1)
    _, jidx = jax.lax.top_k(jprobs, cfg.experts_per_token)
    probs = torch.softmax(torch.from_numpy(xf) @ model.blocks[layer].ff.router,
                          dim=-1)
    _, idx = MOE.top_k(probs, cfg.experts_per_token)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    return MOE.capacity(xf.shape[0], cfg), aux["load"]


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_moe_apply_matches_jax(capacity_factor):
    """At the smoke capacity (2.0) and at 0.5, where assignments drop."""
    jcfg, jparams, cfg, model = _pair(capacity_factor=capacity_factor)
    cap, load = _check_layer(jcfg, jparams, cfg, model, _x(cfg))
    n_drop = int(MOE.dropped(cap, load))
    assert (n_drop > 0) == (capacity_factor < 1.0), (cap, load)


def test_moe_apply_two_experts_per_token_matches_jax():
    jcfg, jparams, cfg, model = _pair(experts_per_token=2,
                                      capacity_factor=0.75)
    cap, load = _check_layer(jcfg, jparams, cfg, model, _x(cfg, seed=1),
                             layer=1)
    assert int(MOE.dropped(cap, load)) > 0


def test_router_tie_goes_to_lower_expert():
    """Two equal router columns: every token's probabilities tie between
    experts 1 and 3; both packages pick 1, and the whole layer agrees."""
    jcfg, jparams, cfg, model = _pair()
    router = np.array(model.blocks[0].ff.router)
    router[:, 1] += 10.0 * np.abs(router).max()   # make 1 and 3 the top two
    router[:, 3] = router[:, 1]
    with torch.no_grad():
        model.blocks[0].ff.router.copy_(torch.from_numpy(router))
    jparams["blocks"]["b0"]["ff"]["router"] = jparams["blocks"]["b0"]["ff"][
        "router"].at[0].set(router)
    x = np.abs(_x(cfg, seed=2))               # x @ router's 10x term > 0
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, cfg.d_model))
                          @ model.blocks[0].ff.router, dim=-1)
    assert torch.equal(probs[:, 1], probs[:, 3])
    _, idx = MOE.top_k(probs, 2)
    assert (idx[:, 0] == 1).all() and (idx[:, 1] == 3).all()
    _check_layer(jcfg, jparams, cfg, model, x)


@pytest.mark.parametrize("T,k,E,cf,cap", [
    (8, 1, 4, 1.25, 2), (12, 1, 4, 1.25, 4), (8, 1, 16, 1.25, 1),
    (3, 2, 8, 2.0, 2), (2, 1, 16, 1.25, 1), (1024, 1, 16, 1.25, 80)])
def test_capacity_is_the_reference_host_arithmetic(T, k, E, cf, cap):
    """2.5 rounds to 2, 1.5 to 2 and 3.75 to 4 (banker's round), 0.625 to
    1, never below 1 — the reference's expression evaluated on the host."""
    cfg = dataclasses.replace(smoke_config(ARCH), n_experts=E,
                              experts_per_token=k, capacity_factor=cf)
    assert MOE.capacity(T, cfg) == cap == int(max(1, round(T * k / E * cf)))


def test_train_forward_matches_jax(scout):
    jcfg, jparams, cfg, model = scout
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jtot, jm = jtrain_forward(jparams, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels)}, jcfg)
    tot, m = train_forward(model, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)}, cfg)
    assert float(m["aux_loss"]) > 0.0
    for got, want in ((tot, jtot), (m["ce_loss"], jm["ce_loss"]),
                      (m["aux_loss"], jm["aux_loss"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# serving: the port's BatchedEngine against the reference's
# ---------------------------------------------------------------------------
def _staggered(cfg, n, seed=0, stagger=3, max_new=30):
    rng = np.random.default_rng(seed)
    return [(u + 1, rng.integers(0, cfg.vocab_size,
                                 int(rng.integers(4, 33))).astype(np.int32),
             int(rng.integers(4, max_new)), stagger * u) for u in range(n)]


def _both_engines(pair, spec, paged, kv_policy=None, **bs):
    """(reference tokens, port tokens, port engine) of one workload. Both
    engines upload their slot inputs whole (``io_upload="full"``): the
    reference's delta upload hands ``jnp.asarray`` its numpy dirty mask,
    which JAX may alias on the CPU, and clears the mask right after the
    asynchronous dispatch, so under load the upload can miss a new slot
    (ROADMAP C-ref4). The two upload modes serve the same tokens."""
    jcfg, jparams, cfg, model = pair
    kw = dict(paged_decode=paged, scheduler="fifo", io_upload="full", **bs)
    jpol = None if kv_policy is None else JPolicy.from_dict(
        kv_policy.to_dict())
    want = JBatched(jcfg, JBatchedConfig(kv_policy=jpol, **kw), jparams).run(
        [JRequest(uid=u, tokens=t, max_new=m, arrival=a)
         for u, t, m, a in spec])
    eng = BatchedEngine(cfg, BatchedServeConfig(kv_policy=kv_policy, **kw),
                        model)
    got = eng.run([Request(uid=u, tokens=t, max_new=m, arrival=a)
                   for u, t, m, a in spec])
    assert sorted(want) == sorted(got)
    for u in want:
        np.testing.assert_array_equal(
            got[u], np.asarray(want[u]),
            err_msg=f"{cfg.name} paged={paged}: request {u}")
    return want, got, eng


@pytest.mark.parametrize("paged", [True, False])
def test_batched_engine_matches_reference_scout(scout, paged):
    spec = _staggered(scout[2], 8)
    _, got, eng = _both_engines(scout, spec, paged, slots=4, max_seq=64)
    assert eng.stats["emitted_tokens"] == sum(m for _, _, m, _ in spec)
    assert eng.stats["prefills"] == len(spec)


@pytest.mark.parametrize("paged", [True, False])
def test_batched_engine_matches_reference_maverick_two_formats(paged):
    pair = _pair("llama4_maverick_400b")
    pol = FormatPolicy.from_dict({"rules": [
        {"pattern": "kv/b0", "fmt": "f2p_sr_2_8s", "block": 0},
        {"pattern": "kv/b1", "fmt": "f2p_lr_1_6s", "block": 0}]})
    spec = _staggered(pair[2], 5, seed=1, max_new=14)
    _, _, eng = _both_engines(pair, spec, paged, kv_policy=pol, slots=3,
                              max_seq=64)
    homes = eng.pool.slabs if paged else eng.caches
    assert homes["b0"]["k"].fmt == named_format("f2p_sr_2_8s")
    assert homes["b1"]["v"].fmt == named_format("f2p_lr_1_6s")
    per = {key: sum(eng.pool.slabs[key][kv].nbytes for kv in ("k", "v"))
           for key in ("b0", "b1")}
    assert per["b1"] < per["b0"]
    assert eng.pool.stats()["pool_bytes_packed"] == per["b0"] + per["b1"]
