"""Port parity, the F2P weight-only matmul: ``repro_torch.kernels.f2p_matmul``
against ``repro.kernels.f2p_matmul``.

The same numpy inputs go through both packages. ``quantize_weight`` is
held bitwise (codes, packed words and scales); the port's
``dequant_matmul`` on the CPU (its plain version, which B7/B8 are held to
on the card) is held within rtol=1e-5, atol=1e-4 of the JAX Pallas kernels
in interpret mode, on weights the JAX package quantized
(``quantized_weight_from_jax``). Inside the port the packed path equals the
unpacked one bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.f2p import F2PFormat as JFormat
from repro.core.f2p import Flavor as JFlavor
from repro.kernels import f2p_matmul as JM
from repro_torch.core.f2p import F2PFormat, Flavor
from repro_torch.kernels import f2p_matmul as TM
from repro_torch.models.convert import quantized_weight_from_jax


def _fmts(n_bits, h=2, flavor="sr"):
    return (JFormat(n_bits, h, JFlavor(flavor), signed=True),
            F2PFormat(n_bits, h, Flavor(flavor), signed=True))


def _data(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (M, K)).astype(np.float32),
            rng.normal(0, 0.05, (K, N)).astype(np.float32))


def _bits(t: torch.Tensor) -> np.ndarray:
    """Any tensor's raw bits as numpy (uint16/uint32 through signed views)."""
    view = {torch.uint16: torch.int16, torch.uint32: torch.int32}
    return t.view(view.get(t.dtype, t.dtype)).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    view = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32}
    return a.view(view.get(a.dtype, a.dtype))


@pytest.mark.parametrize("n_bits,h,flavor,packed", [
    (8, 1, "sr", False), (8, 2, "sr", False), (8, 2, "lr", False),
    (6, 2, "sr", True), (8, 2, "sr", True), (10, 2, "sr", True)])
def test_quantize_weight_bitwise_vs_jax(n_bits, h, flavor, packed):
    jf, tf = _fmts(n_bits, h, flavor)
    _, w = _data(8, 512, 384, seed=n_bits + h)
    w[:128, 0] = 0.0                          # an all-zero scale block
    jc, js = JM.quantize_weight(jnp.asarray(w), jf, packed=packed)
    tc, ts = TM.quantize_weight(torch.from_numpy(w), tf, packed=packed)
    assert tc.dtype == {False: torch.uint8 if n_bits <= 8 else torch.uint16,
                        True: torch.uint32}[packed]
    np.testing.assert_array_equal(_bits(tc), _jbits(jc))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))


@pytest.mark.parametrize("shape", [(128, 256, 256), (256, 512, 256),
                                   (128, 256, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_matmul_vs_jax_kernel(shape, dtype):
    M, K, N = shape
    x, w = _data(M, K, N)
    jf, tf = _fmts(8)
    jc, js = JM.quantize_weight(jnp.asarray(w), jf)
    want = np.asarray(JM.f2p_dequant_matmul(
        jnp.asarray(x, jnp.dtype(dtype)), jc, js, fmt=jf, interpret=True))
    codes, scales = quantized_weight_from_jax(jc, js, packed=False,
                                              device="cpu")
    got = TM.dequant_matmul(torch.from_numpy(x).to(getattr(torch, dtype)),
                            codes, scales, fmt=tf)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n_bits", [6, 8, 10])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_matmul_packed_vs_jax_kernel(n_bits, dtype):
    x, w = _data(16, 256, 128, seed=n_bits)
    jf, tf = _fmts(n_bits)
    jw, js = JM.quantize_weight(jnp.asarray(w), jf, packed=True)
    want = np.asarray(JM.f2p_dequant_matmul_packed(
        jnp.asarray(x, jnp.dtype(dtype)), jw, js, fmt=jf, interpret=True))
    words, scales = quantized_weight_from_jax(jw, js, packed=True,
                                              device="cpu")
    got = TM.dequant_matmul(torch.from_numpy(x).to(getattr(torch, dtype)),
                            words, scales, fmt=tf, packed=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("fmt", [("sr", 1), ("sr", 2), ("lr", 2)],
                         ids=lambda f: f"{f[0]}{f[1]}")
def test_dequant_matmul_formats_vs_jax_kernel(fmt):
    x, w = _data(128, 256, 256, seed=5)
    jf, tf = _fmts(8, fmt[1], fmt[0])
    jc, js = JM.quantize_weight(jnp.asarray(w), jf)
    want = np.asarray(JM.f2p_dequant_matmul(jnp.asarray(x), jc, js, fmt=jf,
                                            interpret=True))
    tc, ts = TM.quantize_weight(torch.from_numpy(w), tf)
    got = TM.dequant_matmul(torch.from_numpy(x), tc, ts, fmt=tf)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n_bits", [6, 8, 10])
def test_packed_equals_unpacked_bitwise(n_bits):
    _, tf = _fmts(n_bits)
    x, w = _data(16, 256, 160, seed=n_bits)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    codes, scales = TM.quantize_weight(wt, tf)
    words, scales_p = TM.quantize_weight(wt, tf, packed=True)
    assert torch.equal(scales, scales_p)
    y = TM.dequant_matmul(xt, codes, scales, fmt=tf)
    yp = TM.dequant_matmul(xt, words, scales, fmt=tf, packed=True)
    assert torch.equal(y, yp)
    assert torch.equal(y, TM.ref_dequant_matmul(xt, codes, scales, tf))


def test_quantized_matmul_close_to_exact():
    """F2P8 weights keep the relative output error in the few-percent range
    of 8-bit weight-only serving (the reference's bound)."""
    x, w = _data(128, 512, 256, seed=3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    codes, scales = TM.quantize_weight(wt)
    y_q = TM.dequant_matmul(xt, codes, scales)
    y_exact = xt @ wt
    rel = float(torch.linalg.norm(y_q - y_exact) / torch.linalg.norm(y_exact))
    assert rel < 0.08, rel


@pytest.mark.parametrize("n_bits,packed", [(8, False), (6, True),
                                           (8, True)])
def test_weight_bytes_under_bf16(n_bits, packed):
    _, tf = _fmts(n_bits)
    _, w = _data(8, 512, 256)
    codes, scales = TM.quantize_weight(torch.from_numpy(w), tf,
                                       packed=packed)
    q_bytes = codes.numel() * codes.element_size() + scales.numel() * 4
    assert q_bytes < w.size * 2 * 0.6       # < 60% of the bf16 footprint
    if packed:
        assert q_bytes == w.shape[0] * -(-w.shape[1] * n_bits // 32) * 4 \
            + scales.numel() * 4


def test_preconditions_raise():
    _, tf = _fmts(8)
    x, w = _data(128, 256, 256)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    codes, scales = TM.quantize_weight(wt)
    words, _ = TM.quantize_weight(wt, packed=True)
    with pytest.raises(ValueError, match="block"):
        TM.quantize_weight(wt[:200])                       # K % block
    with pytest.raises(ValueError, match="multiple of 256"):
        TM.dequant_matmul(xt[:, :128], codes[:128], scales[:1])   # K % 256
    with pytest.raises(ValueError, match="K="):
        TM.dequant_matmul(xt, codes[:, :128].contiguous()[:128],
                          scales[:1, :128])
    with pytest.raises(ValueError, match="tiles"):
        TM.dequant_matmul(torch.zeros(130, 256), codes, scales)   # M % 128
    x2, w2 = _data(8, 256, 384)
    c2, s2 = TM.quantize_weight(torch.from_numpy(w2))
    with pytest.raises(ValueError, match="tiles"):
        TM.dequant_matmul(torch.from_numpy(x2), c2, s2)          # N % 256
    with pytest.raises(ValueError, match="scales"):
        TM.dequant_matmul(xt, codes, scales[:, :128])
    with pytest.raises(TypeError, match="codes must be"):
        TM.dequant_matmul(xt, codes.to(torch.int32), scales)
    with pytest.raises(ValueError, match="words"):
        TM.dequant_matmul(xt, words[:, :-1].contiguous(), scales,
                          packed=True)
    with pytest.raises(ValueError, match="2-D"):
        TM.dequant_matmul(xt[None], codes, scales)
    # the reference raises on the same calls
    jc, js = JM.quantize_weight(jnp.asarray(w))
    with pytest.raises(AssertionError):
        JM.f2p_dequant_matmul(jnp.zeros((130, 256)), jc, js, interpret=True)


def test_small_decode_shapes_run_the_plain_version():
    """M below the row tile (a decode batch) and odd M pass the
    preconditions and agree with the reference's oracle."""
    jf, tf = _fmts(8)
    for M in (1, 5, 8):
        x, w = _data(M, 256, 256, seed=M)
        jc, js = JM.quantize_weight(jnp.asarray(w), jf)
        want = np.asarray(JM.ref_dequant_matmul(jnp.asarray(x), jc, js, jf))
        codes, scales = quantized_weight_from_jax(jc, js, packed=False,
                                                  device="cpu")
        got = TM.dequant_matmul(torch.from_numpy(x), codes, scales, fmt=tf)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_matmul_split_covers_the_card():
    """The launch plan: a row tile covering M (8 rows for a decode batch),
    K split only while the output tiles leave the SMs idle."""
    assert TM.matmul_split(8, 3072, 3072, 132) == (8, 11)
    assert TM.matmul_split(8, 128256, 3072, 132) == (8, 1)
    assert TM.matmul_split(2048, 8192, 3072, 132) == (128, 1)
    assert TM.matmul_split(5, 256, 256, 132) == (8, 8)
    bm, splits = TM.matmul_split(130, 1024, 8192, 132)
    assert bm == 128 and 1 <= splits <= 32


# llama3.2-3b's projections (K, N) -> the decode route's (rows, K chunk,
# splits) at M = 8 on 132 SMs
_DECODE_PLANS = {(3072, 3072): (288, 11), (3072, 1024): (96, 32),
                 (3072, 8192): (768, 4), (8192, 3072): (752, 11),
                 (3072, 128256): (1024, 3)}


@pytest.mark.parametrize("K,N", sorted(_DECODE_PLANS))
def test_decode_plan_covers_the_card(K, N):
    """The decode route's launch: ceil(N / 256) column groups x K splits
    fill one wave of a CTA per SM to within a column group (more only
    where a chunk would pass 1024 rows), each chunk a whole number of
    16-row steps, and the chunks cover K exactly once."""
    chunk, splits = TM.decode_plan(8, N, K, 132)
    assert (chunk, splits) == _DECODE_PLANS[(K, N)]
    assert chunk % 16 == 0 and chunk <= 1024
    assert (splits - 1) * chunk < K <= splits * chunk
    groups = -(-N // 256)
    assert 132 - groups <= groups * splits <= 132 or splits == -(-K // 1024)


def test_matmul_route_by_rows():
    """M up to MM_DECODE_ROWS takes the decode route, whose plan does not
    depend on M, a larger M the tile route; a scale block that is not a
    whole number of 4-row units keeps the tile route."""
    assert TM.MM_DECODE_ROWS == 8
    for M in range(1, TM.MM_DECODE_ROWS + 1):
        assert TM.matmul_route(M, 128) == "decode"
        assert TM.decode_plan(M, 256, 512, 132) == TM.decode_plan(8, 256, 512, 132)
    for M in (TM.MM_DECODE_ROWS + 1, 64, 2048):
        assert TM.matmul_route(M, 128) == "tile"
    assert TM.matmul_route(8, 2) == "tile"
