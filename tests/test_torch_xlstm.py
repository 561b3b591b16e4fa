"""Port parity, the xLSTM mixers: ``repro_torch.models.xlstm`` against the
JAX reference's ``repro.models.xlstm`` on smoke xLSTM (f32, d_model 64,
4 heads, mLSTM expand 2: head_dim 32), the reference's weights carried
over by ``params_from_jax`` (layer 0 mLSTM, layer 3 sLSTM) and the inputs
drawn with numpy from a seed.

* mLSTM, chunkwise form: S = 512 (two chunks of ``MLSTM_CHUNK``) and S =
  300 (not a multiple: one chunk of the whole sequence), train and
  prefill, the prefill also from a non-zero incoming (C, n, m); its O(1)
  decode. Outputs and states within rtol = atol = 1e-5 (f32 sums taken in
  other orders).
* sLSTM: train, prefill from a non-zero state and decode, within 1e-5.
* Each mixer's state continues: a prefill of a + b equals a prefill of a
  followed by one decode per token of b, in outputs and state (1e-5; the
  mLSTM's chunkwise and recurrent forms are the same function).
* The caches' shapes, dtypes and ``m = -1e30`` start equal the
  reference's.
"""
import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import xlstm as JXL
from repro_torch.configs import smoke_config
from repro_torch.models import init_caches
from repro_torch.models import xlstm as XL
from repro_torch.models.convert import params_from_jax

CPU = torch.device("cpu")
ARCH = "xlstm_125m"
TOL = dict(rtol=1e-5, atol=1e-5)
MLSTM_KEYS, SLSTM_KEYS = ("C", "n", "m"), ("c", "n", "h", "m")


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jax_smoke(ARCH), smoke_config(ARCH)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jcfg, jparams, cfg, model


def _layer(pair, pos):
    """(JAX cfg, JAX leaves of position ``pos``, port cfg, port mixer) of
    group 0: position 0 is an mLSTM, 3 the sLSTM."""
    jcfg, jparams, cfg, model = pair
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][f"b{pos}"]["mixer"])
    return jcfg, jp, cfg, model.blocks[pos].mixer


def _x(cfg, B, S, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _zero_state(jcfg, B, kind):
    st = (JXL.init_mlstm_cache(jcfg, B) if kind == "mlstm"
          else JXL.init_slstm_cache(jcfg, B))
    return {k: np.asarray(v) for k, v in st.items()}


def _run_state(jcfg, B, kind, seed=1):
    """A state reached by running: the reference's prefill of 6 random
    tokens from zero (so m, n and C are consistent)."""
    jcfg_, jp = jcfg
    x = _x(jcfg_, B, 6, seed=seed)
    fn = JXL.mlstm_apply if kind == "mlstm" else JXL.slstm_apply
    _, st = fn(jp, jnp.asarray(x), jcfg_, mode="prefill",
               cache={k: jnp.asarray(v) for k, v in
                      _zero_state(jcfg_, B, kind).items()})
    return {k: np.asarray(v) for k, v in st.items()}


def _port_cache(st):
    return {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


def _check_state(cache, jcache, keys):
    for k in keys:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("S", [512, 300])
def test_mlstm_train_matches_jax(pair, S):
    jcfg, jp, cfg, mix = _layer(pair, 0)
    x = _x(cfg, 2, S, seed=S)
    jout, _ = JXL.mlstm_apply(jp, jnp.asarray(x), jcfg, mode="train")
    out = XL.mlstm_apply(mix, torch.from_numpy(x), cfg, mode="train")
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("S", [512, 300])
@pytest.mark.parametrize("start", ["zero", "state"])
def test_mlstm_prefill_matches_jax(pair, S, start):
    jcfg, jp, cfg, mix = _layer(pair, 0)
    B = 2
    st = (_zero_state(jcfg, B, "mlstm") if start == "zero"
          else _run_state((jcfg, jp), B, "mlstm"))
    x = _x(cfg, B, S, seed=S + 1)
    jout, jc = JXL.mlstm_apply(jp, jnp.asarray(x), jcfg, mode="prefill",
                               cache={k: jnp.asarray(v)
                                      for k, v in st.items()})
    cache = _port_cache(st)
    out = XL.mlstm_apply(mix, torch.from_numpy(x), cfg, mode="prefill",
                         cache=cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    _check_state(cache, jc, MLSTM_KEYS)


@pytest.mark.parametrize("kind,pos", [("mlstm", 0), ("slstm", 3)])
def test_decode_matches_jax(pair, kind, pos):
    jcfg, jp, cfg, mix = _layer(pair, pos)
    jfn = JXL.mlstm_apply if kind == "mlstm" else JXL.slstm_apply
    fn = XL.mlstm_apply if kind == "mlstm" else XL.slstm_apply
    keys = MLSTM_KEYS if kind == "mlstm" else SLSTM_KEYS
    B = 3
    st = _run_state((jcfg, jp), B, kind, seed=5)
    jc = {k: jnp.asarray(v) for k, v in st.items()}
    cache = _port_cache(st)
    for t in range(4):
        x = _x(cfg, B, 1, seed=20 + t)
        jout, jc = jfn(jp, jnp.asarray(x), jcfg, mode="decode", cache=jc)
        out = fn(mix, torch.from_numpy(x), cfg, mode="decode", cache=cache)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        _check_state(cache, jc, keys)


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_slstm_matches_jax(pair, mode):
    jcfg, jp, cfg, mix = _layer(pair, 3)
    B, S = 2, 24
    x = _x(cfg, B, S, seed=9)
    cache = None
    if mode == "prefill":
        st = _run_state((jcfg, jp), B, "slstm", seed=3)
        cache = _port_cache(st)
        jcache = {k: jnp.asarray(v) for k, v in st.items()}
    else:
        jcache = None
    jout, jc = JXL.slstm_apply(jp, jnp.asarray(x), jcfg, mode=mode,
                               cache=jcache)
    out = XL.slstm_apply(mix, torch.from_numpy(x), cfg, mode=mode,
                         cache=cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    if cache is not None:
        _check_state(cache, jc, SLSTM_KEYS)


@pytest.mark.parametrize("kind,pos", [("mlstm", 0), ("slstm", 3)])
def test_prefill_then_decode_continues_the_state(pair, kind, pos):
    jcfg, jp, cfg, mix = _layer(pair, pos)
    jfn = JXL.mlstm_apply if kind == "mlstm" else JXL.slstm_apply
    fn = XL.mlstm_apply if kind == "mlstm" else XL.slstm_apply
    keys = MLSTM_KEYS if kind == "mlstm" else SLSTM_KEYS
    B, La, Lb = 2, 11, 5
    x = _x(cfg, B, La + Lb, seed=13)
    zero = _zero_state(jcfg, B, kind)
    jout, jc = jfn(jp, jnp.asarray(x), jcfg, mode="prefill",
                   cache={k: jnp.asarray(v) for k, v in zero.items()})
    whole = _port_cache(zero)
    out = fn(mix, torch.from_numpy(x), cfg, mode="prefill", cache=whole)
    step = _port_cache(zero)
    fn(mix, torch.from_numpy(x[:, :La]), cfg, mode="prefill", cache=step)
    for t in range(La, La + Lb):
        o = fn(mix, torch.from_numpy(x[:, t:t + 1]), cfg, mode="decode",
               cache=step)
        np.testing.assert_allclose(o.numpy(), out[:, t:t + 1].numpy(), **TOL)
        np.testing.assert_allclose(o.numpy(), np.asarray(jout[:, t:t + 1]),
                                   **TOL)
    for k in keys:
        np.testing.assert_allclose(step[k].numpy(), whole[k].numpy(), **TOL,
                                   err_msg=k)
    _check_state(step, jc, keys)


def test_caches_match_reference_layout(pair):
    jcfg, _, cfg, _ = pair
    jc = jinit_caches(jcfg, 3, 16)
    tc = init_caches(cfg, 3, 16, device=CPU)
    assert sorted(jc) == sorted(tc) == ["b0", "b1", "b2", "b3"]
    for key in jc:
        assert sorted(jc[key]) == sorted(tc[key]), key
        for leaf, a in jc[key].items():
            b = tc[key][leaf]
            assert tuple(a.shape) == tuple(b.shape), (key, leaf)
            assert b.dtype == torch.float32, (key, leaf)
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    m0 = float(np.float32(-1e30))
    assert float(tc["b0"]["m"].max()) == float(tc["b3"]["m"].min()) == m0
