"""Port parity, codec layer: ``repro_torch`` against the JAX reference.

Everything here must be BITWISE equal: n-bit word packing, the copied F2P
format's codes, and the packed and unpacked quantize (codes or words, and
scales) / dequantize of ``repro_torch.core.qtensor`` against
``repro.core.qtensor`` on the xla backend (and, for the unpacked codec, the
Pallas kernels in interpret mode). Inputs are made from numpy seeds and
handed to both packages.
"""
import itertools

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qtensor as QT
from repro.core.f2p import F2PFormat as JF2PFormat
from repro.core.formats import named_format as jnamed
from repro.kernels import f2p_quant as JK
from repro.kernels import ops as JOPS
from repro.kernels.bits import pack_bits_np, unpack_bits_np
from repro_torch.core import qtensor as TQ
from repro_torch.core.f2p import F2PFormat, Flavor
from repro_torch.core.formats import named_format
from repro_torch.kernels import bits as TB
from repro_torch.kernels import f2p_quant as TK
from repro_torch.kernels import ops as TOPS


@pytest.mark.parametrize("n_bits", range(1, 20))
def test_pack_unpack_bits_bitwise(n_bits):
    """Odd lengths and fields straddling word boundaries, 1..19 bits."""
    rng = np.random.default_rng(n_bits)
    for n in (1, 5, 31, 33, 67):
        codes = rng.integers(0, 1 << n_bits, (3, n)).astype(np.uint32)
        want = pack_bits_np(codes, n_bits)
        got = TB.pack_bits(torch.from_numpy(codes.astype(np.int64)), n_bits)
        assert got.dtype == torch.uint32
        np.testing.assert_array_equal(got.numpy(), want)
        back = TB.unpack_bits(got, n_bits, n)
        np.testing.assert_array_equal(back.numpy(),
                                      unpack_bits_np(want, n_bits, n))
        np.testing.assert_array_equal(TB.pack_bits_np(codes, n_bits), want)


_FMTS = [(fl, h, n, s) for fl, h, n, s in itertools.product(
    ("sr", "lr", "si", "li"), (1, 2), (6, 8, 11, 16), (False, True))]


@pytest.mark.parametrize("fl,h,n,s", _FMTS)
def test_copied_format_codes_match_reference(fl, h, n, s):
    """The port's copy of core.f2p encodes/decodes code for code like the
    reference (grid points, midpoint ties, one ulp either side, clamps)."""
    ref = JF2PFormat(n, h, fl, s)
    fmt = F2PFormat(n, h, fl, s)
    g = ref.payload_grid
    mid = (g[:-1] + g[1:]) / 2.0
    rng = np.random.default_rng(n * 10 + h)
    x = np.concatenate([g, mid, np.nextafter(mid, -np.inf),
                        np.nextafter(mid, np.inf),
                        rng.uniform(0, ref.max_value * 1.1, 256),
                        [0.0, ref.max_value * 8, 1e300]])
    if s:
        x = np.concatenate([x, -x, [-0.0]])
    np.testing.assert_array_equal(fmt.encode_nearest(x), ref.encode_nearest(x))
    codes = np.arange(1 << n)
    np.testing.assert_array_equal(fmt.decode(codes), ref.decode(codes))
    assert fmt.max_value == ref.max_value


def _case(shape, seed, zero_block=False, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    if zero_block:
        x[..., :32] = 0.0
        x[0] = 0.0
    return x


_QCASES = [
    ("f2p_sr_2_8s", (4, 128), 128, "f32", False),
    ("f2p_sr_2_6s", (3, 5, 100), 32, "f32", True),
    ("f2p_lr_2_16s", (2, 3, 77), 32, "f32", False),
    ("f2p_lr_2_8s", (6, 64), 32, "pow2", True),
    ("f2p_sr_1_6s", (7, 200), 64, "pow2", False),
    ("f2p_sr_2_16s", (5, 128), 128, "f32", True),
    ("f2p_li_2_8u", (4, 96), 32, "f32", False),
]


@pytest.mark.parametrize("name,shape,block,mode,zero", _QCASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_quantize_dequantize_bitwise(name, shape, block, mode, zero,
                                            dtype):
    x = _case(shape, seed=len(name) + block, zero_block=zero, scale=3.0)
    jfmt, fmt = jnamed(name), named_format(name)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = QT.quantize(jx, jfmt, block=block, scale_mode=mode, backend="xla",
                       packed=True)
    got = TQ.quantize(tx, fmt, block=block, scale_mode=mode, packed=True)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert got.nbytes == want.nbytes
    for out in ("float32", "bfloat16"):
        wd = np.asarray(QT.dequantize(want, dtype=jnp.dtype(out),
                                      backend="xla").astype(jnp.float32))
        gd = got.dequantize(getattr(torch, out)).to(torch.float32).numpy()
        np.testing.assert_array_equal(gd, wd)


def test_tile_math_codes_match_reference_tile_math():
    """Raw encode/decode tile math on values around every grid point."""
    enc = jax.jit(JK.quantize_tile_math, static_argnums=1)
    dec = jax.jit(JK.dequantize_tile_math, static_argnums=1)
    for name in ("f2p_sr_2_8s", "f2p_lr_1_8s", "f2p_sr_2_10s", "f2p_lr_2_6s"):
        jfmt, fmt = jnamed(name), named_format(name)
        g = jfmt.grid.astype(np.float32)
        x = np.concatenate([g, np.nextafter(g, np.float32(np.inf)),
                            np.nextafter(g, np.float32(-np.inf)),
                            ((g[:-1] + g[1:]) / 2).astype(np.float32)])
        want = np.asarray(enc(jnp.asarray(x), jfmt))
        got = TK.quantize_tile_math(torch.from_numpy(x), fmt).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int32))
        codes = np.arange(1 << fmt.n_bits, dtype=np.int32)
        np.testing.assert_array_equal(
            TK.dequantize_tile_math(torch.from_numpy(codes), fmt).numpy(),
            np.asarray(dec(jnp.asarray(codes), jfmt)))


def test_dynamic_update_in_place_and_validation():
    fmt = F2PFormat(8, 2, Flavor.SR, signed=True)
    base = TQ.quantize(torch.zeros(2, 6, 3, 16), fmt, block=16, packed=True)
    upd = TQ.quantize(torch.ones(2, 1, 3, 16), fmt, block=16, packed=True)
    codes = base.codes
    out = base.dynamic_update(upd, 4, axis=1)
    assert out is base and out.codes.data_ptr() == codes.data_ptr()
    np.testing.assert_array_equal(out.codes[:, 4].numpy(),
                                  upd.codes[:, 0].numpy())
    np.testing.assert_array_equal(out.dequantize()[:, 4].numpy(),
                                  np.ones((2, 3, 16), np.float32))
    with pytest.raises(ValueError):
        TQ.QTensor.from_parts(base.codes[..., :3], base.scales, fmt, 16,
                              base.shape, packed=True)
    # the unpacked layout validates its code dtype and padded width
    flat = TQ.quantize(torch.zeros(2, 16), fmt, block=16, packed=False)
    with pytest.raises(ValueError, match="codes must be"):
        TQ.QTensor.from_parts(flat.codes.to(torch.int32), flat.scales, fmt,
                              16, (2, 16), packed=False)
    with pytest.raises(ValueError, match="padded logical dim"):
        TQ.QTensor.from_parts(flat.codes[:, :8], flat.scales, fmt, 16,
                              (2, 16), packed=False)
    # and updates in place like the packed one
    ub = TQ.quantize(torch.zeros(2, 6, 16), fmt, block=16, packed=False)
    uu = TQ.quantize(torch.ones(2, 1, 16), fmt, block=16, packed=False)
    assert ub.dynamic_update(uu, 2, axis=1) is ub
    np.testing.assert_array_equal(ub.dequantize()[:, 2].numpy(),
                                  np.ones((2, 16), np.float32))


# ---------------------------------------------------------------------------
# The unpacked codec (B5 / B6 plain versions) against the reference
# ---------------------------------------------------------------------------
_UCASES = [
    # name, shape, block, scale mode, zero blocks
    ("f2p_sr_2_8s", (4, 128), 128, "f32", False),
    ("f2p_sr_2_8s", (3, 7, 300), 128, "f32", True),      # odd dim, padded
    ("f2p_lr_2_8s", (6, 64), 32, "pow2", True),
    ("f2p_sr_2_6s", (3, 5, 100), 32, "f32", True),
    ("f2p_lr_2_6s", (9, 96), 32, "pow2", False),
    ("f2p_sr_1_6s", (7, 200), 64, "pow2", False),
    ("f2p_sr_2_16s", (5, 128), 128, "f32", True),
    ("f2p_sr_2_16s", (3072,), 128, "f32", False),         # a 1-D norm
    ("f2p_lr_2_16s", (2, 3, 77), 32, "f32", False),
    ("f2p_lr_2_16s", (4, 256), 128, "pow2", True),
    ("f2p_li_2_8u", (4, 96), 32, "f32", False),
]


@pytest.mark.parametrize("name,shape,block,mode,zero", _UCASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unpacked_quantize_dequantize_bitwise(name, shape, block, mode, zero,
                                              dtype):
    """Codes (uint8 / uint16), scales and values equal JAX
    ``backend="xla"`` bitwise."""
    x = _case(shape, seed=len(name) * 7 + block, zero_block=zero, scale=3.0)
    jfmt, fmt = jnamed(name), named_format(name)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = QT.quantize(jx, jfmt, block=block, scale_mode=mode, backend="xla")
    got = TQ.quantize(tx, fmt, block=block, scale_mode=mode, packed=False)
    assert not got.packed
    assert str(got.codes.dtype).split(".")[-1] == str(
        np.asarray(want.codes).dtype)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert got.nbytes == want.nbytes
    for out in ("float32", "bfloat16"):
        wd = np.asarray(QT.dequantize(want, dtype=jnp.dtype(out),
                                      backend="xla").astype(jnp.float32))
        gd = got.dequantize(getattr(torch, out)).to(torch.float32).numpy()
        np.testing.assert_array_equal(gd, wd)


@pytest.mark.parametrize("name", ["f2p_sr_2_8s", "f2p_lr_2_8s",
                                  "f2p_sr_2_16s"])
@pytest.mark.parametrize("mode", ["f32", "pow2"])
def test_unpacked_codec_non_finite_blocks_bitwise(name, mode):
    """Blocks holding a NaN, a -NaN and an inf, as a diverged gradient
    brings them: codes, scales (1 for a NaN block) and values equal JAX
    ``backend="xla"`` bitwise."""
    x = _case((4, 384), seed=3, zero_block=False, scale=3.0)
    x[0, 5], x[1, 200], x[2, 7] = np.nan, -np.nan, np.inf
    jfmt, fmt = jnamed(name), named_format(name)
    want = QT.quantize(jnp.asarray(x), jfmt, block=128, scale_mode=mode,
                       backend="xla")
    got = TQ.quantize(torch.from_numpy(x), fmt, block=128, scale_mode=mode,
                      packed=False)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scales.numpy().view(np.int32),
                                  np.asarray(want.scales).view(np.int32))
    assert float(got.scales[0, 0]) == float(got.scales[1, 1]) == 1.0
    wd = np.asarray(QT.dequantize(want, dtype=jnp.float32, backend="xla"))
    np.testing.assert_array_equal(got.dequantize().numpy(), wd)


@pytest.mark.parametrize("name,mode", [("f2p_sr_2_8s", "f32"),
                                       ("f2p_lr_2_6s", "pow2"),
                                       ("f2p_sr_2_16s", "pow2"),
                                       ("f2p_lr_2_16s", "f32")])
def test_unpacked_2d_plain_matches_pallas_interpret(name, mode):
    """The plain versions of B5/B6 against the TPU kernels themselves
    (``_quant_kernel`` / ``_dequant_kernel`` in interpret mode)."""
    x = _case((16, 256), seed=11, zero_block=True, scale=2.0)
    jfmt, fmt = jnamed(name), named_format(name)
    jc, js = JK.f2p_quantize_pallas(jnp.asarray(x), jfmt, block=128,
                                    scale_mode=mode, interpret=True)
    tc, ts = TK.f2p_quantize_codes(torch.from_numpy(x), fmt, block=128,
                                   scale_mode=mode)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = JK.f2p_dequantize_pallas(jc, js, jfmt, block=128, interpret=True)
    td = TK.f2p_dequantize_codes(tc, ts, fmt, block=128)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("name", ["f2p_sr_2_6s", "f2p_sr_2_8s",
                                  "f2p_lr_2_16s"])
def test_pack_unpack_and_scale_by_bitwise(name):
    x = _case((3, 4, 200), seed=5, zero_block=True, scale=2.0)
    jfmt, fmt = jnamed(name), named_format(name)
    want = QT.quantize(jnp.asarray(x), jfmt, block=64, backend="xla")
    got = TQ.quantize(torch.from_numpy(x), fmt, block=64, packed=False)
    wp, gp = want.pack(), got.pack()
    assert gp.packed and gp.codes.dtype == torch.uint32
    np.testing.assert_array_equal(gp.codes.numpy(), np.asarray(wp.codes))
    # packed twin == quantize(packed=True); unpack is the exact inverse
    direct = TQ.quantize(torch.from_numpy(x), fmt, block=64, packed=True)
    np.testing.assert_array_equal(gp.codes.numpy(), direct.codes.numpy())
    back = gp.unpack()
    assert back.codes.dtype == got.codes.dtype
    np.testing.assert_array_equal(back.codes.numpy(), got.codes.numpy())
    np.testing.assert_array_equal(back.codes.numpy(),
                                  np.asarray(wp.unpack().codes))
    assert got.pack() is not got and gp.pack() is gp and got.unpack() is got
    ws, gs = want.scale_by(0.25), got.scale_by(0.25)
    np.testing.assert_array_equal(gs.scales.numpy(), np.asarray(ws.scales))
    np.testing.assert_array_equal(
        gs.dequantize().numpy(), np.asarray(ws.dequantize(backend="xla")))


def test_ops_and_tree_helpers_match_reference():
    fmt, jfmt = named_format("f2p_sr_2_8s"), jnamed("f2p_sr_2_8s")
    x = _case((6, 160), seed=9)
    want = JOPS.f2p_quantize(jnp.asarray(x), jfmt, block=32, backend="xla")
    got = TOPS.f2p_quantize(torch.from_numpy(x), fmt, block=32)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    wd = JOPS.f2p_dequantize(want.codes, want.scales, jfmt, block=32,
                             backend="xla")
    gd = TOPS.f2p_dequantize(got.codes, got.scales, fmt, block=32)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    # collapsed 2-D codes with extra rows cut back to out_shape
    c2 = torch.cat([got.codes, got.codes[:2]])
    s2 = torch.cat([got.scales, got.scales[:2]])
    np.testing.assert_array_equal(
        TOPS.f2p_dequantize(c2, s2, fmt, block=32, out_shape=(2, 3, 160))
        .reshape(6, 160).numpy(), np.asarray(wd))
    tree = {"w": torch.from_numpy(_case((64, 32), seed=1)),
            "b": torch.from_numpy(_case((8,), seed=2)),
            "n": [torch.arange(3)]}
    jtree = {"w": jnp.asarray(tree["w"].numpy()),
             "b": jnp.asarray(tree["b"].numpy()), "n": [jnp.arange(3)]}
    q = TQ.quantize_tree(tree, fmt, block=32, min_size=1024)
    jq = QT.quantize_tree(jtree, jfmt, block=32, min_size=1024,
                          backend="xla")
    assert isinstance(q["w"], TQ.QTensor) and q["b"] is tree["b"]
    np.testing.assert_array_equal(q["w"].codes.numpy(),
                                  np.asarray(jq["w"].codes))
    d = TQ.dequantize_tree(q)
    jd = QT.dequantize_tree(jq, backend="xla")
    np.testing.assert_array_equal(d["w"].numpy(), np.asarray(jd["w"]))
    assert d["n"][0] is tree["n"][0]


@pytest.mark.parametrize("name", ["f2p_sr_2_6s", "f2p_sr_2_8s",
                                  "f2p_lr_2_16s"])
def test_quantize_default_storage_matches_reference(name, monkeypatch):
    """``quantize`` with no ``packed=`` gives the reference's storage: the
    same flag, code dtype and codes, bitwise (the reference reads
    ``F2P_PACKED`` for its default; unset, that is unpacked)."""
    monkeypatch.delenv("F2P_PACKED", raising=False)
    x = _case((3, 5, 200), seed=11, zero_block=True, scale=2.0)
    want = QT.quantize(jnp.asarray(x), jnamed(name), block=64, backend="xla")
    got = TQ.quantize(torch.from_numpy(x), named_format(name), block=64)
    assert got.packed == want.packed is False
    assert str(got.codes.dtype).split(".")[-1] == str(
        np.asarray(want.codes).dtype)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    flat = TQ.QTensor.from_parts(got.codes, got.scales, got.fmt, 64,
                                 got.shape)
    assert flat.packed is False


def test_quantize_kv_stores_packed_words():
    """The KV cache's quantizer asks for packed words itself: uint32 words
    equal to the reference's ``packed=True`` quantize, bitwise."""
    from repro_torch.models.attention import KV_FMT, quantize_kv

    x = _case((2, 7, 3, 64), seed=4, zero_block=False, scale=1.5)
    got = quantize_kv(torch.from_numpy(x))
    want = QT.quantize(jnp.asarray(x), jnamed("f2p_sr_2_8s"), block=64,
                       backend="xla", packed=True)
    assert KV_FMT == named_format("f2p_sr_2_8s")
    assert got.packed and got.codes.dtype == torch.uint32
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
