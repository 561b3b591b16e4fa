"""Port parity, the F2P weight-only matmul: ``repro_torch.kernels.f2p_matmul``
against ``repro.kernels.f2p_matmul``.

The same numpy inputs go through both packages. ``quantize_weight`` is
held bitwise (codes, packed words and scales); the port's
``dequant_matmul`` on the CPU (its plain version, which B7/B8 are held to
on the card) is held within rtol=1e-5, atol=1e-4 of the JAX Pallas kernels
in interpret mode, on weights the JAX package quantized
(``quantized_weight_from_jax``). Inside the port the packed path equals the
unpacked one bitwise. The tile route's tensor-core kernel runs only on the
card; here its choice of format and block (``tile_kernel``), its launch
plan (``mma_plan``), its split of f32 x into three bf16 terms and its
arithmetic (emulated in PyTorch) are held to the JAX kernels.
"""
import _torch_threads  # noqa: F401
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


# ---------------------------------------------------------------------------
# The tile route's tensor-core kernel (dequant_matmul_mma_kernel): which
# formats and blocks it takes, and its arithmetic emulated on the CPU
# ---------------------------------------------------------------------------
_MMA_FORMATS = ["f2p_sr_2_6s", "f2p_sr_2_7s", "f2p_sr_2_8s", "f2p_sr_1_8s",
                "f2p_lr_1_6s", "f2p_lr_2_8s", "f2p_sr_2_9s", "f2p_sr_2_10s",
                "f2p_lr_2_10s"]
_SIMT_FORMATS = ["f2p_sr_2_12s", "f2p_sr_2_16s", "f2p_lr_1_10s",
                 "f2p_lr_2_16s"]


def _sig_bits_by_fractions(fmt) -> int:
    """Significant bits of every decoded value, counted one code at a time
    from its exact rational value (independent of the helper's frexp)."""
    from fractions import Fraction

    from repro_torch.kernels.f2p_quant import dequantize_tile_math

    d = dequantize_tile_math(torch.arange(1 << fmt.n_bits,
                                          dtype=torch.int32), fmt)
    most = 0
    for v in d.double().tolist():
        if v == 0:
            continue
        f = abs(Fraction(v))
        num, den = f.numerator, f.denominator   # den is a power of two
        while num % 2 == 0:
            num //= 2
        most = max(most, num.bit_length())
        assert den & (den - 1) == 0
    return most


@pytest.mark.parametrize("name", _MMA_FORMATS + _SIMT_FORMATS)
def test_tile_kernel_by_format_and_block(name):
    """The tensor-core kernel takes a format of at most 10 bits whose
    decoded values hold at most 8 significant bits (bf16's), at every
    block of whole 16-row mma steps (16 to 256); the SIMT kernel the wider
    formats and block 8. The bit count is the helper's over all codes."""
    from repro_torch.core.formats import named_format

    fmt = named_format(name)
    sig = TM.significant_bits(fmt)
    assert sig == _sig_bits_by_fractions(fmt)
    want = "mma" if name in _MMA_FORMATS else "simt"
    assert (sig <= 8 and fmt.n_bits <= 10) == (want == "mma")
    for block in (16, 32, 64, 128, 256):
        assert TM.tile_kernel(fmt, block) == want
    assert TM.tile_kernel(fmt, 8) == "simt"
    # the table's power of two: max |d| * 2^-e in [0.5, 1)
    from repro_torch.kernels.f2p_quant import dequantize_tile_math

    d = dequantize_tile_math(torch.arange(1 << fmt.n_bits,
                                          dtype=torch.int32), fmt)
    top = float(d.abs().max()) * 2.0 ** -TM.mma_shift(fmt)
    assert 0.5 <= top < 1.0


_MASK16 = torch.tensor(-65536, dtype=torch.int32)    # 0xFFFF0000


def _split3(x: torch.Tensor):
    """The kernel's split of f32 x (split3 / split3_nonfinite): x_hi keeps
    x's top 16 bits, x_mid those of the exact rest r = x - x_hi, x_lo
    those of r - x_mid; an inf or NaN rides in x_hi alone (a NaN kept a
    NaN by its quiet bit), with x_mid = x_lo = 0."""
    u = x.view(torch.int32)
    fin = torch.isfinite(x)
    hi = (u & _MASK16).view(torch.float32)
    r = torch.where(fin, x - hi, torch.zeros_like(x))
    mid = (r.view(torch.int32) & _MASK16).view(torch.float32)
    lo = ((r - mid).view(torch.int32) & _MASK16).view(torch.float32)
    quiet = torch.where(torch.isnan(x), 0x00400000, 0).to(torch.int32)
    hi = ((u & _MASK16) | quiet).view(torch.float32)
    return hi, mid, lo


def _split_inputs(kind: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    big = np.finfo(np.float32).max
    if kind == "random":
        e = rng.integers(-110, 127, 4096)
        return (rng.uniform(1, 2, 4096) * np.exp2(e.astype(np.float64))
                * rng.choice([-1, 1], 4096)).astype(np.float32)
    if kind == "extremes":
        return np.array([big, -big, np.nextafter(big, 0, dtype=np.float32),
                         2.0 ** -110, -(2.0 ** -110) * 1.9999999,
                         np.finfo(np.float32).tiny], np.float32)
    if kind == "subnormal":
        bits = np.concatenate([rng.integers(1, 1 << 23, 4096),
                               np.arange(1, 64) << 16, [1, 0x7FFFFF]])
        sign = rng.choice([0, 1 << 31], bits.size)
        return (bits.astype(np.uint32) | sign.astype(np.uint32)).view(
            np.float32)
    if kind == "zero":
        return np.array([0.0, -0.0], np.float32)
    if kind == "inf":
        return np.array([np.inf, -np.inf], np.float32)
    # NaNs: quiet, signalling, payload only in the low 16 bits, negative
    return np.array([0x7FC00000, 0x7F800001, 0x7F80FFFF, 0xFFC00000,
                     0x7FFFFFFF], np.uint32).view(np.float32)


@pytest.mark.parametrize("kind", ["random", "extremes", "subnormal", "zero",
                                  "inf", "nan"])
def test_split3_rule(kind):
    """x_hi + x_mid + x_lo == x bitwise for every finite x that is a
    multiple of 2^-133 (bf16's least subnormal; every |x| >= 2^-110),
    each term a bf16 value of at most 8 significant bits; below that the
    lost part is under 2^-133. inf and NaN ride in x_hi alone."""
    x = torch.from_numpy(_split_inputs(kind))
    hi, mid, lo = _split3(x)
    for t in (hi, mid, lo):     # bf16 values: the low 16 bits are zero
        assert int((t.view(torch.int32) & 0xFFFF).abs().sum()) == 0
    fin = torch.isfinite(x)
    if not bool(fin.all()):
        assert torch.equal(torch.isnan(hi), torch.isnan(x))
        assert torch.equal(torch.isinf(hi), torch.isinf(x))
        assert torch.equal(torch.signbit(hi), torch.signbit(x))
        assert float(mid[~fin].abs().sum()) == 0.0
        assert float(lo[~fin].abs().sum()) == 0.0
        return
    total = (hi + mid) + lo
    xd = x.double()
    exact = torch.frac(xd * 2.0 ** 133) == 0
    if kind != "subnormal":
        assert bool(exact.all())
    # equal values: bit for bit, but for -0 (its rest is +0)
    assert bool((total[exact] == x[exact]).all())
    assert bool(((total.double() - xd).abs() < 2.0 ** -133).all())


def _mma_emulation(x: torch.Tensor, codes: torch.Tensor,
                   scales: torch.Tensor, fmt, block: int) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in plain PyTorch: decoded
    weights d' = d * 2^-e exact in bf16, x split into three bf16 terms (f32
    x) or taken as it is (bf16 x), each block's products summed small
    terms first, then y += (s * 2^e) * block sum."""
    from repro_torch.kernels.f2p_quant import (codes_to_int32,
                                               dequantize_tile_math)

    e = TM.mma_shift(fmt)
    d = dequantize_tile_math(codes_to_int32(codes), fmt) * 2.0 ** -e
    assert torch.equal(d.to(torch.bfloat16).float(), d)
    if x.dtype == torch.float32:
        terms = _split3(x)
    else:
        terms = (x.float(),)
    for t in terms:
        assert torch.equal(t.to(torch.bfloat16).float(), t)
    M, K = x.shape
    y = torch.zeros(M, codes.shape[1])
    for kb in range(K // block):
        rows = slice(kb * block, (kb + 1) * block)
        blk = torch.zeros_like(y)
        for t in reversed(terms):
            blk = blk + t[:, rows] @ d[rows]
        y = y + (scales[kb] * 2.0 ** e) * blk
    return y


@pytest.mark.parametrize("M", [9, 64, 256])
@pytest.mark.parametrize("block", [16, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,packed", [("f2p_sr_2_6s", True),
                                         ("f2p_sr_2_8s", False),
                                         ("f2p_lr_2_8s", True),
                                         ("f2p_sr_2_10s", False)])
def test_mma_arithmetic_vs_jax_kernel(M, block, dtype, name, packed):
    """The tensor-core kernel's arithmetic (``_mma_emulation``) against
    the JAX package's ``f2p_dequant_matmul`` / ``f2p_dequant_matmul_packed``
    in interpret mode, on weights the JAX package quantized, within the
    tolerance the port's plain version is held to (rtol 1e-5, atol 1e-4)."""
    from repro.core.formats import named_format as jnamed
    from repro_torch.core.formats import named_format
    from repro_torch.kernels.bits import unpack_bits

    jf, tf = jnamed(name), named_format(name)
    assert TM.tile_kernel(tf, block) == "mma"
    x, w = _data(M, 256, 128, seed=M + block)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    if packed:
        jw, js = JM.quantize_weight(jnp.asarray(w), jf, block=block,
                                    packed=True)
        want = JM.f2p_dequant_matmul_packed(jx, jw, js, fmt=jf, block=block,
                                            interpret=True)
        words, scales = quantized_weight_from_jax(jw, js, packed=True,
                                                  device="cpu")
        codes = unpack_bits(words, tf.n_bits, 128)
    else:
        jc, js = JM.quantize_weight(jnp.asarray(w), jf, block=block)
        want = JM.f2p_dequant_matmul(jx, jc, js, fmt=jf, block=block,
                                     interpret=True)
        codes, scales = quantized_weight_from_jax(jc, js, packed=False,
                                                  device="cpu")
    got = _mma_emulation(torch.from_numpy(x).to(getattr(torch, dtype)),
                         codes, scales, tf, block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_mma_plan_covers_the_card():
    """The tensor-core kernel's launch: 64 or 128 rows covering M, K split
    in whole 64-row steps (chunks of at least 128 rows) only while the
    output tiles leave SMs idle, the chunks covering K once."""
    assert TM.mma_plan(2048, 8192, 3072, 132) == (128, 3072, 1)
    assert TM.mma_plan(2048, 128256, 3072, 132) == (128, 3072, 1)
    assert TM.mma_plan(16, 8192, 3072, 132) == (64, 1536, 2)
    assert TM.mma_plan(128, 8192, 3072, 132) == (128, 1536, 2)
    assert TM.mma_plan(64, 3072, 8192, 132)[0] == 64
    for M, N, K in ((9, 256, 512), (100, 768, 512), (2048, 1024, 3072),
                    (256, 100, 256), (128, 1024, 8192)):
        bm, chunk, splits = TM.mma_plan(M, N, K, 132)
        assert bm >= min(M, 128) and bm in (64, 128)
        assert chunk % 64 == 0 and (chunk >= 128 or splits == 1)
        assert (splits - 1) * chunk < K <= splits * chunk and splits <= 32
