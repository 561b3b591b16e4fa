"""Port parity, the gradient round trip with error feedback (B5's round-trip
mode) on the CPU: its plain version against the JAX reference's
``compress_decompress``, B5's table-driven encode against the arithmetic
tile math, and the leaf plan that the card's one launch per step walks.

Tolerances: none. The round trip is integer work plus IEEE-rounded adds,
divides and multiplies in the same order on both sides, so gradients and
residuals are compared BITWISE; a NaN is compared by position (its payload
is not part of the contract).
"""
import _torch_threads  # noqa: F401
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.formats import named_format as jnamed_format
from repro.optim import CompressionConfig as JCompressionConfig
from repro.optim import compress_decompress as jcompress
from repro_torch.configs import smoke_config
from repro_torch.core.formats import named_format
from repro_torch.kernels import f2p_quant as Q
from repro_torch.models import init_params
from repro_torch.models.convert import reference_numel
from repro_torch.optim import (CompressionConfig, compress_decompress,
                               init_residuals)
from repro_torch.optim.compress import compressed_leaves

# ragged last dims (200, 300, 70), a cols % 4 != 0 leaf (70) and a 1-D one
SHAPES = {"a": (5, 200), "b": (3, 128), "c": (300,), "d": (2, 3, 70)}


def _same_bits(a: np.ndarray, b: np.ndarray, what: str) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    na, nb = np.isnan(a.astype(np.float32)), np.isnan(b.astype(np.float32))
    np.testing.assert_array_equal(na, nb, err_msg=f"{what}: NaN positions")
    ints = {2: np.uint16, 4: np.uint32}[a.dtype.itemsize]
    np.testing.assert_array_equal(np.where(na, 0, a.view(ints)),
                                  np.where(nb, 0, b.view(ints)), err_msg=what)


def _leaves(seed: int, special: bool):
    """f32 gradients (randn x 1e-2) and residuals (randn x 1e-4) of SHAPES;
    with ``special``, an all-zero block (gradient and residual) and a NaN
    block in leaf a, and a -NaN in leaf d."""
    rng = np.random.default_rng(seed)
    g = {k: rng.normal(size=s).astype(np.float32) * 1e-2
         for k, s in SHAPES.items()}
    r = {k: rng.normal(size=s).astype(np.float32) * 1e-4
         for k, s in SHAPES.items()}
    if special:
        g["a"][0, :128] = 0
        r["a"][0, :128] = 0
        g["a"][1, 150] = np.nan
        g["d"][1, 2, 9] = -np.nan
    return g, r


@pytest.mark.parametrize("special", [False, True], ids=["randn", "zero_nan"])
@pytest.mark.parametrize("fmt_name", ["f2p_sr_2_8s", "f2p_lr_2_8s"])
@pytest.mark.parametrize("error_feedback", [True, False], ids=["ef", "no_ef"])
@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
def test_plain_roundtrip_matches_jax(gdtype, error_feedback, fmt_name,
                                     special):
    g_np, r_np = _leaves(7, special)
    if gdtype == "bfloat16":
        g_np = {k: v.astype(ml_dtypes.bfloat16) for k, v in g_np.items()}
    jg, jr = jcompress(
        {k: jnp.asarray(v) for k, v in g_np.items()},
        {k: jnp.asarray(v) for k, v in r_np.items()},
        JCompressionConfig(fmt=jnamed_format(fmt_name, signed=True),
                           block=128, min_size=1,
                           error_feedback=error_feedback))
    # the same input bits on both sides (torch's f32 -> bf16 cast gives a
    # NaN another sign than ml_dtypes' does)
    gs = {k: torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
          if gdtype == "bfloat16" else torch.from_numpy(v.copy())
          for k, v in g_np.items()}
    rs = {k: torch.from_numpy(v.copy()) for k, v in r_np.items()}
    fmt = named_format(fmt_name, signed=True)
    for k in SHAPES:
        Q.ef_roundtrip_plain(gs[k], rs[k], fmt, 128, error_feedback)
    for k in SHAPES:
        got = gs[k].float().numpy() if gdtype == "bfloat16" \
            else gs[k].numpy()
        _same_bits(got.astype(np.float32),
                   np.asarray(jg[k]).astype(np.float32), f"gradient {k}")
        _same_bits(rs[k].numpy(), np.asarray(jr[k]), f"residual {k}")
    if not error_feedback:
        for k in SHAPES:
            _same_bits(rs[k].numpy(), r_np[k], f"untouched residual {k}")


@pytest.mark.parametrize("error_feedback", [True, False])
def test_roundtrip_wrapper_on_cpu_is_the_plain_version(error_feedback):
    g_np, r_np = _leaves(3, True)
    fmt = named_format("f2p_sr_2_8s", signed=True)
    gs = [torch.from_numpy(v.astype(ml_dtypes.bfloat16).view(np.int16))
          .view(torch.bfloat16) for v in g_np.values()]
    rs = [torch.from_numpy(v.copy()) for v in r_np.values()]
    pg, pr = [g.clone() for g in gs], [r.clone() for r in rs]
    Q.f2p_ef_roundtrip(gs, rs, fmt, error_feedback=error_feedback)
    for a, b, c, d in zip(gs, rs, pg, pr):
        Q.ef_roundtrip_plain(c, d, fmt, 128, error_feedback)
        _same_bits(a.float().numpy(), c.float().numpy(), "gradient")
        _same_bits(b.numpy(), d.numpy(), "residual")
    with pytest.raises(ValueError, match="gradients but"):
        Q.f2p_ef_roundtrip(gs, rs[:-1], fmt)


def _patterns() -> torch.Tensor:
    """f32 bit patterns: every biased exponent, both signs, mantissas at
    and around every power-of-two rounding boundary down to 2^-10 of the
    binade, and random ones (NaN payloads are exponent 255's)."""
    rng = np.random.default_rng(0)
    mants = [rng.integers(0, 1 << 23, 512)]
    for s in range(11):
        base = np.arange(1 << s, dtype=np.int64) << (23 - s)
        half = 1 << max(22 - s, 0)
        mants += [base + d for d in (-1, 0, 1, half - 1, half, half + 1)]
    mants = np.unique(np.clip(np.concatenate(mants), 0, (1 << 23) - 1))
    bits = (np.arange(256, dtype=np.int64)[:, None] << 23 | mants).ravel()
    bits = np.concatenate([bits, bits | 1 << 31]).astype(np.uint32)
    return torch.from_numpy(bits.view(np.int32)).view(torch.float32)


@pytest.mark.parametrize("name", ["f2p_sr_2_8s", "f2p_sr_2_16s",
                                  "f2p_lr_1_6s", "f2p_lr_2_8s",
                                  "f2p_si_2_8s", "f2p_li_2_16s",
                                  "f2p_sr_1_8", "f2p_sr_2_6s"])
def test_table_encode_matches_tile_math(name):
    """B5's table encode (code and decoded value) is the arithmetic encode,
    bit for bit, over every exponent and the mantissas at its rounding
    boundaries; the card holds it over all 2^32 patterns."""
    fmt = named_format(name)
    y = _patterns()
    code, value = Q.table_encode(y, fmt)
    want = Q.quantize_tile_math(y, fmt)
    assert torch.equal(code, want)
    assert torch.equal(value.view(torch.int32),
                       Q.dequantize_tile_math(want, fmt).view(torch.int32))


def _walk(table: np.ndarray, nblocks: int, block: int):
    """The kernel's walk over a launch's global block index: (leaf, first
    element, valid elements) per block."""
    blk0 = table[:, 2] & 0xFFFFFFFF
    cols, nbr = table[:, 2] >> 32, table[:, 3] & 0xFFFFFFFF
    out = []
    for b in range(nblocks):
        leaf = int(np.searchsorted(blk0[:-1], b, side="right")) - 1
        local = b - blk0[leaf]
        row, j = divmod(int(local), int(nbr[leaf]))
        out.append((leaf, row * int(cols[leaf]) + j * block,
                    min(block, int(cols[leaf]) - j * block)))
    return out


@pytest.mark.parametrize("max_blocks", [None, 16])
def test_ef_plan_covers_every_block_of_every_leaf_once(monkeypatch,
                                                       max_blocks):
    if max_blocks:
        monkeypatch.setattr(Q, "EF_MAX_BLOCKS", max_blocks)
    block = 128
    shapes = [((5, 200), torch.float32), ((3, 128), torch.bfloat16),
              ((0, 64), torch.float32), ((300,), torch.bfloat16),
              ((2, 3, 70), torch.float32), ((3, 513), torch.bfloat16)]
    gs = [torch.zeros(s, dtype=dt) for s, dt in shapes]
    rs = [torch.zeros(s) for s, _ in shapes]
    live = [(g, r) for g, r in zip(gs, rs) if g.numel()]
    plan = Q.ef_plan(gs, rs, block)
    assert len(plan) == (1 if max_blocks is None else 3)
    seen = []
    for table, nblocks in plan:
        assert table.dtype == np.int64 and table[-1, 2] == nblocks
        nbr = table[:-1, 3] & 0xFFFFFFFF
        cols = table[:-1, 2] >> 32
        rows = [int(np.prod(s[:-1])) for s in
                [tuple(g.shape) for g, _ in live[len(seen):len(seen) + len(
                    table) - 1]]]
        np.testing.assert_array_equal(   # prefix sums of rows x blocks
            table[:, 2] & 0xFFFFFFFF,
            np.concatenate([[0], np.cumsum(np.array(rows) * nbr)]))
        assert nblocks <= Q.EF_MAX_BLOCKS
        covered = [np.zeros(live[len(seen) + i][0].numel(), np.int64)
                   for i in range(len(table) - 1)]
        for leaf, first, valid in _walk(table, nblocks, block):
            assert 0 < valid <= block
            covered[leaf][first:first + valid] += 1
        for i, c in enumerate(covered):
            g, r = live[len(seen) + i]
            np.testing.assert_array_equal(c, 1)
            assert table[i, 0] == g.data_ptr() and table[i, 1] == r.data_ptr()
            assert cols[i] == g.shape[-1]
            assert nbr[i] == -(-g.shape[-1] // block)
            flags = table[i, 3] >> 32
            assert (flags & 1) == (g.dtype == torch.bfloat16)
            assert (flags >> 1 & 1) == (g.shape[-1] % 4 == 0)
        seen += covered
    assert len(seen) == len(live)


def test_compressed_leaves_follow_min_size_and_residuals():
    model = init_params(smoke_config("llama3_2_3b"), seed=0, device="cpu")
    P = len(model.cfg.pattern)
    grads = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    sizes = reference_numel(grads, P)
    min_size = sorted(set(sizes.values()))[1]
    ccfg = CompressionConfig(min_size=min_size)
    res = init_residuals(model, ccfg, P)
    names = compressed_leaves(grads, res, ccfg, P)
    assert names == [n for n in grads if sizes[n] >= min_size]
    assert 0 < len(names) < len(grads)
    assert all(res[n] is not None for n in names)
    res[names[0]] = None     # a leaf without a residual is not compressed
    assert compressed_leaves(grads, res, ccfg, P) == names[1:]
    res[names[0]] = torch.zeros(3)
    with pytest.raises(ValueError, match="residual shape"):
        compressed_leaves(grads, res, ccfg, P)
    with pytest.raises(ValueError, match="names must match"):
        compressed_leaves(grads, {}, ccfg, P)


def test_compress_decompress_on_cpu_skips_small_leaves():
    model = init_params(smoke_config("llama3_2_3b"), seed=0, device="cpu")
    P = len(model.cfg.pattern)
    rng = np.random.default_rng(1)
    grads = {n: torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(
        np.float32) * 1e-2) for n, p in model.named_parameters()}
    sizes = reference_numel(grads, P)
    ccfg = CompressionConfig(min_size=sorted(set(sizes.values()))[1])
    res = init_residuals(model, ccfg, P)
    before = {n: g.clone() for n, g in grads.items()}
    compress_decompress(grads, res, ccfg, P)
    for n, g in grads.items():
        if res[n] is None:
            assert torch.equal(g, before[n]), n
        else:
            w, wr = before[n].clone(), torch.zeros_like(before[n])
            Q.ef_roundtrip_plain(w, wr, ccfg.fmt, ccfg.block)
            assert torch.equal(g, w) and torch.equal(res[n], wr), n
