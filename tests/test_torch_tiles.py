"""The tile tables: ``attention_tile`` / ``set_attention_tile`` /
``autotune_attention_tile`` and ``matmul_tiles`` / ``set_matmul_tiles`` /
``autotune_matmul_tiles`` / ``tiles=`` against the reference's.

The reference keys its tables by an XLA / Pallas backend; the port keys
them by the device type, ``"cuda"`` (the kernels' launches) or ``"cpu"``
(the plain versions). The semantics are the reference's: a default when
no entry, per-(backend, n_bits) overrides, an explicit ``tile=`` /
``tiles=`` winning, the ``N_T % 32`` error, a tuner that installs its
winner and refuses a backend without tiles. On ``"cuda"`` an entry must be
one the kernels take (a multiple of 16 positions per CTA; N_T = 128, M_T
an instance's rows, K_T a multiple of 64), and B7's tile-route plan
(``tile_plan``, a host function) follows it. The port's plain attention
at tiles 64, 256 and 512 holds against the reference's at the same tile
within 1e-5, and paged == dense over the gathered pages bitwise at each.
"""
import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qtensor as QT
from repro.core.f2p import F2PFormat as JF2PFormat
from repro.core.f2p import Flavor as JFlavor
from repro.kernels import f2p_attention as JA
from repro.kernels import f2p_matmul as JM
from repro_torch.core import qtensor as TQ
from repro_torch.core.f2p import F2PFormat, Flavor
from repro_torch.core.formats import named_format
from repro_torch.kernels import f2p_attention as TA
from repro_torch.kernels import f2p_matmul as TM
from repro_torch.models.convert import quantized_weight_from_jax

FMT = (8, 2, "sr", True)


@pytest.fixture(autouse=True)
def _clean_tile_tables():
    """The tile tables are module globals: every test starts and ends
    with both packages' tables empty."""
    tables = (TA._TILE_TABLE, TM._TILE_TABLE, JA._TILE_TABLE,
              JM._TILE_TABLE)
    for t in tables:
        t.clear()
    yield
    for t in tables:
        t.clear()


def _both(x, hd):
    jq = QT.quantize(jnp.asarray(x), JF2PFormat(*FMT), block=hd,
                     backend="xla", packed=True)
    tq = TQ.quantize(torch.from_numpy(x), F2PFormat(*FMT), block=hd,
                     packed=True)
    return jq, tq


def _cache(B, S, K, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, K, hd)).astype(np.float32)
            for _ in range(2)]


def test_attention_tile_table_is_the_references():
    """Defaults, per-(backend, n_bits) overrides, other keys untouched: the
    port under "cpu" / "cuda" as the reference under "xla" / "pallas"."""
    assert TA.DEFAULT_TILE == JA.DEFAULT_TILE == 128
    for n in (6, 8, 16):
        assert TA.attention_tile("cpu", n) == JA.attention_tile("xla", n)
        assert TA.attention_tile("cuda", n) == JA.attention_tile("pallas", n)
    TA.set_attention_tile("cpu", 6, 256)
    JA.set_attention_tile("xla", 6, 256)
    TA.set_attention_tile("cuda", 8, 512)
    JA.set_attention_tile("pallas", 8, 512)
    for (tb, jb) in (("cpu", "xla"), ("cuda", "pallas")):
        for n in (6, 8, 16):
            assert TA.attention_tile(tb, n) == JA.attention_tile(jb, n)
    assert TA.attention_tile("cpu", 6.0) == 256     # n_bits as the key's int
    assert TA.attention_tile("cpu", 8) == TA.attention_tile("cuda", 6) == 128


def test_matmul_tile_table_is_the_references():
    assert (TM.M_T, TM.N_T, TM.K_T) == (JM.M_T, JM.N_T, JM.K_T)
    for n in (6, 8):
        assert TM.matmul_tiles("cpu", n) == JM.matmul_tiles("xla", n) \
            == (128, 256, 256)
    TM.set_matmul_tiles("cpu", 6, (64, 96, 128))
    JM.set_matmul_tiles("xla", 6, (64, 96, 128))
    assert TM.matmul_tiles("cpu", 6) == JM.matmul_tiles("xla", 6)
    assert TM.matmul_tiles("cpu", 8) == TM.matmul_tiles("cuda", 6) \
        == (128, 256, 256)
    with pytest.raises(ValueError, match="word-aligned"):
        JM.set_matmul_tiles("xla", 8, (128, 48, 256))
    with pytest.raises(ValueError, match="word-aligned"):
        TM.set_matmul_tiles("cpu", 8, (128, 48, 256))
    assert TM.matmul_tiles("cpu", 8) == (128, 256, 256)


@pytest.mark.parametrize("tiles,what", [
    ((128, 256, 256), "column tile"),   # the reference's default N_T
    ((96, 128, 256), "M_T"),
    ((128, 128, 96), "K_T"),
    ((128, 128, 0), "K_T"),
])
def test_cuda_matmul_entries_the_kernels_cannot_take_raise(tiles, what):
    with pytest.raises(ValueError, match=what):
        TM.set_matmul_tiles("cuda", 8, tiles)
    assert ("cuda", 8) not in TM._TILE_TABLE
    TM.set_matmul_tiles("cuda", 8, (64, 128, 192))
    assert TM.matmul_tiles("cuda", 8) == (64, 128, 192)


@pytest.mark.parametrize("tile,ok", [(16, True), (64, True), (384, True),
                                     (8, False), (100, False), (0, False),
                                     (2 ** 21, False)])
def test_cuda_attention_entries_the_kernel_cannot_take_raise(tile, ok):
    if ok:
        TA.set_attention_tile("cuda", 8, tile)
        assert TA.attention_tile("cuda", 8) == tile
    else:
        with pytest.raises(ValueError, match="tile"):
            TA.set_attention_tile("cuda", 8, tile)
        assert TA.attention_tile("cuda", 8) == TA.DEFAULT_TILE
    TA.set_attention_tile("cpu", 8, 8)      # the plain version takes any


def test_explicit_tile_wins_over_the_table():
    """A CPU call with tile=None runs at the ("cpu", n_bits) entry, an
    explicit tile at itself, in both packages; the "cuda" entry is not the
    CPU's."""
    B, S, K, G, hd = 2, 300, 2, 3, 16
    k, v = _cache(B, S, K, hd, seed=1)
    q = np.random.default_rng(2).normal(size=(B, 1, K * G, hd)).astype(
        np.float32)
    (jk, tk), (jv, tv) = _both(k, hd), _both(v, hd)
    tq = torch.from_numpy(q)
    kw = dict(kv_len=torch.tensor([300, 211]))
    TA.set_attention_tile("cpu", 8, 64)
    JA.set_attention_tile("xla", 8, 64)
    TA.set_attention_tile("cuda", 8, 256)
    at64 = TA.attention_packed_plain(tq, tk, tv, tile=64, **kw)
    assert torch.equal(TA.attention_packed(tq, tk, tv, **kw), at64)
    assert torch.equal(TA.attention_packed(tq, tk, tv, tile=32, **kw),
                       TA.attention_packed_plain(tq, tk, tv, tile=32, **kw))
    jkw = dict(kv_len=jnp.asarray([300, 211]), backend="xla")
    want = np.asarray(JA.attention_packed(jnp.asarray(q), jk, jv, **jkw))
    np.testing.assert_array_equal(want, np.asarray(JA.attention_packed(
        jnp.asarray(q), jk, jv, tile=64, **jkw)))
    np.testing.assert_allclose(at64.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tile", [64, 256, 512])
def test_plain_attention_at_a_tile_matches_reference_and_paged(tile):
    """Dense against the reference's xla scan at the same tile, paged ==
    dense over the gathered pages bitwise at that tile, and against the
    reference's attention_paged_reference (C-ref1)."""
    B, S, K, G, hd, T = 2, 1104, 2, 3, 32, 8
    k, v = _cache(B, S, K, hd, seed=tile)
    rng = np.random.default_rng(tile + 1)
    q = rng.normal(size=(B, 1, K * G, hd)).astype(np.float32)
    kv_len = np.array([1104, 601], np.int32)
    (jk, tk), (jv, tv) = _both(k, hd), _both(v, hd)
    tq, tl = torch.from_numpy(q), torch.from_numpy(kv_len)
    want = np.asarray(JA.attention_packed(
        jnp.asarray(q), jk, jv, kv_len=jnp.asarray(kv_len), backend="xla",
        tile=tile))
    got = TA.attention_packed(tq, tk, tv, kv_len=tl, tile=tile)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    maxp = S // T
    P = B * maxp + 3
    slab = [rng.normal(size=(P, T, K, hd)).astype(np.float32)
            for _ in range(2)]
    (jks, tks), (jvs, tvs) = _both(slab[0], hd), _both(slab[1], hd)
    pages = rng.permutation(P)[:B * maxp].reshape(B, maxp).astype(np.int32)
    tp = torch.from_numpy(pages)
    paged = TA.attention_paged(tq, tks, tvs, tp, kv_len=tl, tile=tile)
    dense = TA.attention_packed(tq, TA.gather_pages_to_dense(tks, tp),
                                TA.gather_pages_to_dense(tvs, tp), kv_len=tl,
                                tile=tile)
    assert torch.equal(paged, dense)
    wantp = np.asarray(JA.attention_paged_reference(
        jnp.asarray(q), jks, jvs, jnp.asarray(pages),
        kv_len=jnp.asarray(kv_len), tile=tile))
    np.testing.assert_allclose(paged.numpy(), wantp, rtol=1e-5, atol=1e-5)


def test_autotune_attention_tile_on_the_cpu_installs_a_candidate():
    got = TA.autotune_attention_tile("cpu", 8, shape=(1, 256, 2, 32), reps=1)
    assert got in (64, 128, 256)            # 512 > S is skipped
    assert TA.attention_tile("cpu", 8) == got
    assert TA.attention_tile("cuda", 8) == TA.DEFAULT_TILE
    got = TA.autotune_attention_tile("cpu", 6, candidates=(1024, 32),
                                     shape=(1, 128, 1, 16), reps=1)
    assert got == 32 == TA.attention_tile("cpu", 6)
    with pytest.raises(ValueError, match="device type"):
        TA.autotune_attention_tile("xla", 8, shape=(1, 64, 1, 16), reps=1)


def test_autotune_matmul_tiles_refuses_a_backend_without_tiles():
    with pytest.raises(ValueError, match="xla"):
        JM.autotune_matmul_tiles("xla", 8)
    with pytest.raises(ValueError, match="cpu"):
        TM.autotune_matmul_tiles("cpu", 8)
    assert TM._TILE_TABLE == {}


@pytest.mark.parametrize("name,tiles,want", [
    # the tensor-core kernel (at most 8 significant bits, block % 16)
    ("f2p_sr_2_8s", None, ("mma", 128, 128, 8)),
    ("f2p_sr_2_8s", (64, 128, 256), ("mma", 64, 256, 4)),
    ("f2p_sr_2_8s", (128, 128, 1024), ("mma", 128, 1024, 1)),
    ("f2p_sr_2_6s", (128, 128, 384), ("mma", 128, 384, 3)),   # a short tail
    # the f32 SIMT kernel (f2p_sr_2_16s: 13 significant bits)
    ("f2p_sr_2_16s", None, ("simt", 128, 64, 16)),
    ("f2p_sr_2_16s", (32, 128, 512), ("simt", 32, 512, 2)),
])
def test_tile_plan_follows_the_tiles(name, tiles, want):
    """B7's tile-route launch at (M, N, K) = (256, 1024, 1024) on 132 SMs:
    without tiles the planners' (mma_plan / matmul_split), with them M_T
    rows, a K_T chunk and ceil(K / K_T) splits."""
    fmt = named_format(name)
    assert TM.tile_plan(256, 1024, 1024, 132, fmt, 128, tiles) == want
    if tiles is None and want[0] == "mma":
        assert want[1:] == TM.mma_plan(256, 1024, 1024, 132)


@pytest.mark.parametrize("name,tiles", [("f2p_sr_2_8s", (32, 128, 256)),
                                        ("f2p_sr_2_16s", (256, 128, 256)),
                                        ("f2p_sr_2_8s", (64, 256, 256))])
def test_tile_plan_names_what_a_kernel_cannot_take(name, tiles):
    with pytest.raises(ValueError, match="M_T|column"):
        TM.tile_plan(256, 1024, 1024, 132, named_format(name), 128, tiles)


@pytest.mark.parametrize("n_bits", [6, 8])
def test_packed_matmul_tiles_argument_matches_reference(n_bits):
    """``tiles=`` on both packages' B7 at a tiling the reference's Pallas
    grid takes (interpret mode): within rtol 1e-5, atol 1e-4 (as
    tests/test_torch_matmul.py); on the CPU a table entry changes
    nothing (the plain version has no tiles)."""
    rng = np.random.default_rng(n_bits)
    x = rng.normal(size=(32, 256)).astype(np.float32)
    w = (rng.normal(size=(256, 256)) * 0.02).astype(np.float32)
    jf = JF2PFormat(n_bits, 2, JFlavor.SR, signed=True)
    tf = F2PFormat(n_bits, 2, Flavor.SR, signed=True)
    jw, js = JM.quantize_weight(jnp.asarray(w), jf, packed=True)
    want = np.asarray(JM.f2p_dequant_matmul_packed(
        jnp.asarray(x), jw, js, fmt=jf, interpret=True, tiles=(16, 128,
                                                                256)))
    words, scales = quantized_weight_from_jax(jw, js, packed=True,
                                              device="cpu")
    tx = torch.from_numpy(x)
    got = TM.f2p_dequant_matmul_packed(tx, words, scales, fmt=tf,
                                       tiles=(16, 128, 256))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    TM.set_matmul_tiles("cpu", n_bits, (64, 128, 128))
    assert torch.equal(TM.f2p_dequant_matmul_packed(tx, words, scales,
                                                    fmt=tf), got)
