"""Port parity, B4's K+V read: ``f2p_kv_read`` against the JAX reference.

The same packed words and scales (numpy seed: every bit pattern is a code;
zero and inf scales among them) go through the reference's unfused cache
read (``repro.models.attention._cache_read``, on the CPU as the reference's
own tests run it), its Pallas packed dequantize in interpret mode side by
side, and the port's ``f2p_kv_read`` and ``models.attention._cache_read`` on
CPU tensors (the plain version, two ``dequantize_packed_plain`` calls).
Values must be BITWISE equal (a NaN, from an inf scale times a zero code,
compared by position) over 5-, 6-, 7-, 8- and 16-bit formats, K and V in
one format or in two, f32 and bf16 out, a layer view of an L-stacked cache.
"""
import types

import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qtensor as JQT
from repro.core.formats import named_format as jnamed
from repro.kernels.f2p_quant import f2p_dequantize_packed_pallas
from repro.models import attention as JATT
from repro_torch.core import qtensor as TQ
from repro_torch.core.formats import named_format
from repro_torch.kernels import f2p_quant as Q
from repro_torch.kernels.bits import packed_words
from repro_torch.models import attention as TATT
from repro_torch.models.model import layer_cache

FMTS = ["f2p_sr_2_6s", "f2p_sr_2_8s", "f2p_lr_2_16s", "f2p_sr_1_5s",
        "f2p_sr_2_7s"]
L, B, S, K, HD = 3, 2, 6, 2, 32
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _parts(rng, name):
    """Words [L, B, S, K, W] of random bits and scales [L, B, S, K, 1]
    (randn, with a zero and an inf scale in every layer)."""
    W = packed_words(HD, named_format(name).n_bits)
    codes = rng.integers(0, 1 << 32, (L, B, S, K, W), dtype=np.uint64) \
        .astype(np.uint32)
    scales = rng.standard_normal((L, B, S, K, 1)).astype(np.float32)
    scales[:, 0, 1, 0] = 0.0
    scales[:, 1, 2, 1] = np.inf
    return codes, scales


def _caches(rng, kname, vname, layer):
    """The same layer ``layer`` of one packed cache, for each package."""
    port, ref = {}, {}
    for kv, name in (("k", kname), ("v", vname)):
        codes, scales = _parts(rng, name)
        stack = TQ.QTensor.from_parts(
            torch.from_numpy(codes.view(np.int32)).view(torch.uint32),
            torch.from_numpy(scales), named_format(name), HD,
            (L, B, S, K, HD), packed=True)
        port[kv] = stack
        ref[kv] = JQT.QTensor.from_parts(
            jnp.asarray(codes[layer]), jnp.asarray(scales[layer]),
            jnamed(name), HD, (B, S, K, HD), packed=True)
    return layer_cache(port, layer), ref


def _from_jax(a) -> torch.Tensor:
    """A JAX f32 / bf16 array as a torch tensor of the same values (bf16
    through f32, exact)."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _assert_same(got: torch.Tensor, want: torch.Tensor) -> None:
    """Bitwise, NaNs by position (their payloads are each library's)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want))
    ibits = torch.int16 if got.element_size() == 2 else torch.int32
    assert torch.equal(torch.where(nan, 0, got).view(ibits),
                       torch.where(nan, 0, want).view(ibits))


@pytest.mark.parametrize("name", FMTS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kv_read_bitwise_vs_reference_cache_read(name, dtype):
    tdt, jdt = DTYPES[dtype]
    port, ref = _caches(np.random.default_rng(FMTS.index(name)), name, name,
                        1)
    got = Q.f2p_kv_read(port, tdt)
    want = JATT._cache_read(ref, types.SimpleNamespace(jnp_dtype=jdt))
    for g, w in zip(got, want):
        _assert_same(g, _from_jax(w))
    # the model's own cache read is the same call
    for g, m in zip(got, TATT._cache_read(
            port, types.SimpleNamespace(torch_dtype=tdt))):
        _assert_same(g, m)


@pytest.mark.parametrize("kname,vname", [("f2p_sr_2_8s", "f2p_sr_1_5s"),
                                         ("f2p_sr_2_7s", "f2p_lr_2_16s")])
def test_kv_read_sides_in_their_own_formats(kname, vname):
    port, ref = _caches(np.random.default_rng(7), kname, vname, 2)
    got = Q.f2p_kv_read(port, torch.bfloat16)
    want = JATT._cache_read(ref, types.SimpleNamespace(jnp_dtype=jnp.bfloat16))
    for g, w in zip(got, want):
        _assert_same(g, _from_jax(w))


@pytest.mark.parametrize("name", FMTS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kv_read_each_side_equals_the_pallas_kernel(name, dtype):
    """Each side of the K+V read against the reference's Pallas packed
    dequantize (interpret mode) on that side's words [B*S*K, W]."""
    tdt, jdt = DTYPES[dtype]
    port, ref = _caches(np.random.default_rng(11 + FMTS.index(name)), name,
                        name, 0)
    got = Q.f2p_kv_read(port, tdt)
    for g, kv in zip(got, ("k", "v")):
        c = ref[kv]
        w = f2p_dequantize_packed_pallas(
            c.codes.reshape(-1, c.codes.shape[-1]),
            c.scales.reshape(-1, 1), c.fmt, block=HD, out_dtype=jdt,
            interpret=True)
        _assert_same(g.reshape(-1, HD), _from_jax(w))


def test_kv_read_other_dtype_is_cast_from_f32():
    port, _ = _caches(np.random.default_rng(3), "f2p_sr_2_8s", "f2p_sr_2_8s",
                      1)
    k, v = Q.f2p_kv_read(port, torch.float16)
    k32, v32 = Q.kv_read_plain(port, torch.float32)
    assert k.dtype == torch.float16
    assert torch.equal(k, k32.to(torch.float16))
    assert torch.equal(v, v32.to(torch.float16))


@pytest.mark.parametrize("what", ["shape", "block", "packed", "words"])
def test_kv_read_rejects_caches_it_cannot_read(what):
    port, _ = _caches(np.random.default_rng(5), "f2p_sr_2_8s", "f2p_sr_2_8s",
                      0)
    k, v = port["k"], port["v"]
    if what == "shape":
        v = TQ.QTensor(v.codes[:, :3], v.scales[:, :3], v.fmt, v.block,
                       (B, 3, K, HD), True)
    elif what == "block":
        v = TQ.QTensor(v.codes, v.scales.expand(B, S, K, 2), v.fmt, 16,
                       v.shape, True)
    elif what == "packed":
        v = TQ.QTensor(v.codes, v.scales, v.fmt, v.block, v.shape, False)
    else:
        v = TQ.QTensor(v.codes[..., :-1], v.scales, v.fmt, v.block, v.shape,
                       True)
    with pytest.raises(ValueError):
        Q.f2p_kv_read({"k": k, "v": v})
