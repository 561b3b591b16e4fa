"""Port parity, the mamba mixer: ``repro_torch.models.ssm`` against the JAX
reference's ``repro.models.ssm`` on a mamba layer of smoke jamba (f32,
d_model 64, d_inner 128, state 8, conv 4), the reference's weights carried
over by ``params_from_jax`` and the inputs drawn with numpy from a seed.

* ``mamba_apply`` in the train, prefill and decode modes, at S = 8 (one
  chunk) and S = 512 (two chunks of ``SCAN_CHUNK``), with a non-zero conv
  carry and SSM state coming in: outputs and the new state within rtol =
  atol = 1e-5. The port scans inside a chunk by Hillis–Steele, the
  reference by ``associative_scan``: the same products in another order,
  a few f32 ulps per pass.
* S = 300 (longer than a chunk, not a multiple) raises in both packages.
* The state continues: a prefill of a + b gives the state and outputs of a
  prefill of a followed by one decode per token of b (1e-5).
* ``init_params``' undrawn leaves equal the reference's exactly (a_log and
  d_skip f32 in a bf16 model), and the caches have its shapes and dtypes.
"""
import dataclasses

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import ssm as JSSM
from repro_torch.configs import smoke_config
from repro_torch.models import init_caches, init_params
from repro_torch.models import ssm as SSM
from repro_torch.models.convert import params_from_jax

CPU = torch.device("cpu")
ARCH = "jamba_1_5_large"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def layer():
    """(JAX cfg, JAX mamba leaves of layer 0, port cfg, port mixer)."""
    jcfg, cfg = jax_smoke(ARCH), smoke_config(ARCH)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["b0"]["mixer"])
    return jcfg, jp, cfg, model.blocks[0].mixer


def _x(cfg, B, S, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _state(cfg, B, seed=1):
    """A non-zero incoming conv carry and SSM state."""
    rng = np.random.default_rng(seed)
    return {"conv": rng.standard_normal(
                (B, cfg.ssm_conv - 1, cfg.d_inner)).astype(np.float32),
            "ssm": (0.1 * rng.standard_normal(
                (B, cfg.d_inner, cfg.ssm_state))).astype(np.float32)}


def _port_cache(st):
    return {k: torch.from_numpy(v.copy()) for k, v in st.items()}


def _check_state(cache, jcache):
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("S", [8, 512])
def test_mamba_train_matches_jax(layer, S):
    jcfg, jp, cfg, mix = layer
    x = _x(cfg, 2, S)
    jout, jc = JSSM.mamba_apply(jp, jnp.asarray(x), jcfg, mode="train")
    out = SSM.mamba_apply(mix, torch.from_numpy(x), cfg, mode="train")
    assert jc is None
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("S", [8, 512])
@pytest.mark.parametrize("carry", [False, True], ids=["zero", "carry"])
def test_mamba_prefill_matches_jax(layer, S, carry):
    jcfg, jp, cfg, mix = layer
    B = 2
    x = _x(cfg, B, S, seed=S)
    st = _state(cfg, B) if carry else {
        k: np.asarray(v) for k, v in JSSM.init_mamba_cache(
            jcfg, B, jnp.float32).items()}
    jout, jc = JSSM.mamba_apply(jp, jnp.asarray(x), jcfg, mode="prefill",
                                cache={k: jnp.asarray(v)
                                       for k, v in st.items()})
    cache = _port_cache(st)
    out = SSM.mamba_apply(mix, torch.from_numpy(x), cfg, mode="prefill",
                          cache=cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    _check_state(cache, jc)


def test_mamba_decode_matches_jax(layer):
    jcfg, jp, cfg, mix = layer
    B = 3
    st = _state(cfg, B, seed=4)
    jc = {k: jnp.asarray(v) for k, v in st.items()}
    cache = _port_cache(st)
    for t in range(4):
        x = _x(cfg, B, 1, seed=10 + t)
        jout, jc = JSSM.mamba_apply(jp, jnp.asarray(x), jcfg, mode="decode",
                                    cache=jc)
        out = SSM.mamba_apply(mix, torch.from_numpy(x), cfg, mode="decode",
                              cache=cache)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        _check_state(cache, jc)


def test_ragged_long_sequence_raises_in_both(layer):
    """S = 300: longer than one chunk and not a multiple of it."""
    jcfg, jp, cfg, mix = layer
    x = _x(cfg, 1, 300)
    with pytest.raises(AssertionError, match="multiple of scan chunk"):
        JSSM.mamba_apply(jp, jnp.asarray(x), jcfg, mode="train")
    with pytest.raises(ValueError, match="multiple of scan chunk"):
        SSM.mamba_apply(mix, torch.from_numpy(x), cfg, mode="train")


@pytest.mark.parametrize("Q", [1, 5, 16, 256])
def test_chunk_scan_matches_associative_scan(Q):
    rng = np.random.default_rng(Q)
    dA = rng.uniform(0.5, 1.0, (2, Q, 6, 4)).astype(np.float32)
    dBx = rng.standard_normal((2, Q, 6, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 6, 4)).astype(np.float32)
    jall, jlast = JSSM._chunk_scan(jnp.asarray(dA), jnp.asarray(dBx),
                                   jnp.asarray(h0))
    hall, hlast = SSM._chunk_scan(torch.from_numpy(dA), torch.from_numpy(dBx),
                                  torch.from_numpy(h0))
    np.testing.assert_allclose(hall.numpy(), np.asarray(jall), **TOL)
    np.testing.assert_allclose(hlast.numpy(), np.asarray(jlast), **TOL)


def test_prefill_then_decode_continues_the_state(layer):
    """prefill(a + b) == prefill(a), then decode b one token at a time:
    the outputs at b's positions and the final state, in the port and
    against the reference's prefill of a + b."""
    jcfg, jp, cfg, mix = layer
    B, La, Lb = 2, 9, 5
    x = _x(cfg, B, La + Lb, seed=7)
    zero = {k: np.asarray(v) for k, v in JSSM.init_mamba_cache(
        jcfg, B, jnp.float32).items()}
    jout, jc = JSSM.mamba_apply(jp, jnp.asarray(x), jcfg, mode="prefill",
                                cache={k: jnp.asarray(v)
                                       for k, v in zero.items()})
    whole = _port_cache(zero)
    out = SSM.mamba_apply(mix, torch.from_numpy(x), cfg, mode="prefill",
                          cache=whole)
    step = _port_cache(zero)
    SSM.mamba_apply(mix, torch.from_numpy(x[:, :La]), cfg, mode="prefill",
                    cache=step)
    for t in range(La, La + Lb):
        o = SSM.mamba_apply(mix, torch.from_numpy(x[:, t:t + 1]), cfg,
                            mode="decode", cache=step)
        np.testing.assert_allclose(o.numpy(), out[:, t:t + 1].numpy(), **TOL)
        np.testing.assert_allclose(o.numpy(), np.asarray(jout[:, t:t + 1]),
                                   **TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(step[k].numpy(), whole[k].numpy(), **TOL)
    _check_state(step, jc)


def test_undrawn_leaves_and_caches_match_reference():
    """bf16 smoke jamba: the undrawn mamba leaves equal the reference's
    init exactly (a_log and d_skip stay f32), and init_caches' recurrent
    entries have the reference's shapes and dtypes."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="bfloat16")
    cfg = dataclasses.replace(smoke_config(ARCH), dtype="bfloat16")
    jmix = jinit_params(jcfg, jax.random.PRNGKey(0))["blocks"]["b0"]["mixer"]
    mix = init_params(cfg, seed=0, device=CPU).blocks[0].mixer
    assert mix.a_log.dtype == mix.d_skip.dtype == torch.float32
    assert mix.in_proj.dtype == mix.dt_bias.dtype == torch.bfloat16
    for name in ("a_log", "d_skip", "dt_bias", "conv_b"):
        want = np.asarray(jmix[name][0].astype(jnp.float32))
        np.testing.assert_array_equal(getattr(mix, name).float().numpy(),
                                      want, err_msg=name)
    # drawn at their scales: |w| <= 2 x scale (one bf16 rounding over)
    for name, scale in (("in_proj", 0.02), ("conv_w", 0.1)):
        top = float(getattr(mix, name).float().abs().max())
        assert scale < top <= 2 * scale * (1 + 2 ** -8), name
    jc = jinit_caches(jcfg, 3, 16)
    tc = init_caches(cfg, 3, 16, device=CPU)
    for i in (0, 1, 2, 3, 5, 6, 7):
        for leaf in ("conv", "ssm"):
            a, b = jc[f"b{i}"][leaf], tc[f"b{i}"][leaf]
            assert tuple(a.shape) == tuple(b.shape), (i, leaf)
            assert str(a.dtype) == str(b.dtype).removeprefix("torch."), \
                (i, leaf)
    assert set(tc["b4"]) == {"k", "v"}
