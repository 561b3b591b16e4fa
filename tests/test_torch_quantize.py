"""Port parity, the f64 quantization oracle: ``repro_torch.core.quantize``
(min-max quantization of the paper's Sec. III-B and the block-scaled host
oracle) against ``repro.core.quantize``.

Tolerances and why:
- the five functions are the same float64 numpy on copied formats (the
  F2P codes are held to the reference's in ``tests/test_torch_codec.py``),
  so every output is held BITWISE: values, MSEs, codes, scales;
- the port's QTensor quantize (the plain version of B5 on the CPU) against
  the port's ``block_quantize``: within one quantization step of the
  block's scale, the bound ``tests/test_qtensor.py`` holds the reference
  to, because the runtime codec divides in f32 and the oracle in f64.
"""
import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

from repro.core import quantize as JQ
from repro.core.f2p import F2PFormat as JF2P
from repro.core.f2p import Flavor as JFlavor
from repro.core.formats import FPFormat as JFP
from repro.core.formats import IntFormat as JInt
from repro.core.formats import SEADFormat as JSEAD
from repro.core.formats import named_format as jnamed_format
from repro_torch import core as TC
from repro_torch.core import qtensor as QT
from repro_torch.core import quantize as Q
from repro_torch.core.f2p import F2PFormat, Flavor
from repro_torch.core.formats import (FPFormat, IntFormat, SEADFormat,
                                      named_format)

# (reference format, port format): tests/test_quantize.py::FMTS
FMTS = [
    (JF2P(8, 2, JFlavor.SR, signed=True), F2PFormat(8, 2, Flavor.SR, signed=True)),
    (JF2P(8, 2, JFlavor.LR, signed=True), F2PFormat(8, 2, Flavor.LR, signed=True)),
    (JF2P(8, 1, JFlavor.SI, signed=True), F2PFormat(8, 1, Flavor.SI, signed=True)),
    (JF2P(16, 2, JFlavor.LI, signed=True),
     F2PFormat(16, 2, Flavor.LI, signed=True)),
    (JInt(8, signed=True), IntFormat(8, signed=True)),
    (JFP(m_bits=5, e_bits=2, signed=True), FPFormat(m_bits=5, e_bits=2,
                                                    signed=True)),
    (JFP(m_bits=2, e_bits=5, signed=True), FPFormat(m_bits=2, e_bits=5,
                                                    signed=True)),
    (JSEAD(8, signed=True), SEADFormat(8, signed=True)),
    (jnamed_format("fp16", signed=True), named_format("fp16", signed=True)),
    (jnamed_format("bf16", signed=True), named_format("bf16", signed=True)),
    (jnamed_format("tf32", signed=True), named_format("tf32", signed=True)),
]
IDS = [str(p) for _, p in FMTS]
# block_quantize encodes with ``encode_nearest``, which only the F2P formats
# have (in both packages): its cases are FMTS's F2P formats and two more
BLOCK_FMTS = FMTS[:4] + [
    (JF2P(16, 2, JFlavor.SR, signed=True),
     F2PFormat(16, 2, Flavor.SR, signed=True)),
    (JF2P(6, 1, JFlavor.LR, signed=True), F2PFormat(6, 1, Flavor.LR,
                                                    signed=True)),
]

# tests/test_qtensor.py::PARITY_FMTS and the shapes/blocks of its
# test_quantize_matches_grid_oracle
PARITY_FMTS = [
    F2PFormat(8, 2, Flavor.SR, signed=True),
    F2PFormat(8, 2, Flavor.LR, signed=True),
    F2PFormat(8, 1, Flavor.SI, signed=False),
    F2PFormat(8, 2, Flavor.LI, signed=False),
    F2PFormat(16, 2, Flavor.SR, signed=True),
    F2PFormat(16, 1, Flavor.LR, signed=True),
]
SHAPES = [((4, 128), 128), ((3, 100), 32), ((2, 5, 77), 16), ((513,), 128)]


def _vectors(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "normal": rng.normal(0, 1, size=4096),
        "skewed": rng.lognormal(0, 2, size=1000) - 0.5,
        "wide": rng.normal(0, 1e4, size=777),
        "constant": np.full(64, 3.25),
        "zeros": np.zeros(32),
    }


def _blocks(seed: int) -> np.ndarray:
    """[6, 256] rows with a block of zeros, a constant block and outliers."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2.0, size=(6, 256))
    x[1, :128] = 0.0
    x[2, 128:] = -0.75
    x[3, ::17] *= 1e3
    x[4, 5::13] *= 1e-3
    return x


def test_core_exports_the_oracle_without_shadowing_the_submodule():
    assert TC.quantize is Q      # the submodule, not a bare function
    for name in Q.__all__:
        assert getattr(TC, name) is getattr(Q, name), name
    assert set(Q.__all__) == set(JQ.__all__)


@pytest.mark.parametrize("jfmt,fmt", FMTS, ids=IDS)
def test_minmax_quantize_and_mse_bitwise(jfmt, fmt):
    for name, v in _vectors(7).items():
        got, want = Q.minmax_quantize(v, fmt), JQ.minmax_quantize(v, jfmt)
        assert got.dtype == want.dtype == np.float64, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert Q.quantization_mse(v, fmt) == JQ.quantization_mse(v, jfmt), \
            name


@pytest.mark.parametrize("block", [32, 128])
@pytest.mark.parametrize("jfmt,fmt", BLOCK_FMTS,
                         ids=[str(p) for _, p in BLOCK_FMTS])
def test_block_quantize_and_dequantize_bitwise(jfmt, fmt, block):
    x = _blocks(block)
    got, want = Q.block_quantize(x, fmt, block), JQ.block_quantize(x, jfmt,
                                                                    block)
    assert isinstance(got, Q.BlockQuantized) and got.block == want.block
    assert got.fmt is fmt
    assert got.codes.dtype == want.codes.dtype
    np.testing.assert_array_equal(got.codes, want.codes)
    assert got.scales.dtype == want.scales.dtype == np.float32
    np.testing.assert_array_equal(got.scales, want.scales)
    # the zero block keeps scale 1 and decodes to zeros
    assert got.scales[1, 0] == 1.0
    assert not Q.block_dequantize(got)[1, :128].any()
    np.testing.assert_array_equal(Q.block_dequantize(got),
                                  JQ.block_dequantize(want))


def test_block_quantize_rejects_a_ragged_last_dim():
    fmt = F2PFormat(8, 2, Flavor.SR, signed=True)
    with pytest.raises(ValueError, match="not divisible"):
        Q.block_quantize(np.ones((2, 100)), fmt, block=32)


def _data(shape, seed: int, scale=3.0) -> np.ndarray:
    """tests/test_qtensor.py's data: zeros, tiny and huge elements."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, scale, size=shape).astype(np.float32)
    x.flat[::7] = 0.0
    x.flat[3::11] *= 1e-3
    x.flat[5::13] *= 1e3
    return x


@pytest.mark.parametrize("fmt", PARITY_FMTS, ids=str)
@pytest.mark.parametrize("shape,block", SHAPES)
def test_qtensor_quantize_matches_grid_oracle(fmt, shape, block):
    """The port's QTensor codec (B5's plain version on the CPU) against the
    port's f64 oracle, on the padded array: values within one quantization
    step of the per-block scale (the scales differ only by f32-vs-f64
    division rounding)."""
    x = _data(shape, seed=fmt.n_bits * 31 + len(shape) * 7 + shape[-1])
    if not fmt.signed:
        x = np.abs(x)
    qt = QT.quantize(torch.from_numpy(x), fmt, block=block)
    n = shape[-1]
    npad = -(-n // block) * block
    assert tuple(qt.codes.shape) == shape[:-1] + (npad,)
    assert tuple(qt.scales.shape) == shape[:-1] + (npad // block,)
    y = qt.dequantize().numpy()
    assert y.shape == tuple(shape)

    xp = np.zeros(shape[:-1] + (npad,), np.float64)
    xp[..., :n] = x.astype(np.float64)
    bq = Q.block_quantize(xp, fmt, block=block)
    yo = Q.block_dequantize(bq)[..., :n]
    step = np.max(np.diff(fmt.payload_grid))
    bound = qt.scales.numpy().astype(np.float64).max() * step
    assert np.max(np.abs(y - yo)) <= bound + 1e-7
