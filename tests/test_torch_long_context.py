"""Long-context decode attention: a cache of any length.

The kernel's host plan covers a cache of any length S (past 32768
positions: 257 splits of 128, the reference's ``long_500k`` at 524288),
and at the default tile it is, up to S = 32768, the plan it always was.
The port's plain ``attention_packed`` / ``attention_paged`` hold against
the reference at S = 40960 within rtol = atol = 1e-5
(``tests/test_torch_attention.py``'s tolerance), with kv_len near S and at
100; the paged side against the reference's ``attention_paged_reference``
(C-ref1: never the xla paged path). Inside the port, paged == dense over
the gathered pages bitwise, and a page table cut to the live span equals
the full one. The kernel itself runs on the card only (``tests/test_torch_cuda.py``;
``chip_smoke.py --only long`` runs it at 32896, 131072 and 524288).
"""
import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qtensor as QT
from repro.core.f2p import F2PFormat as JF2PFormat
from repro.kernels import f2p_attention as JA
from repro.kernels import f2p_matmul as JM
from repro_torch.core import qtensor as TQ
from repro_torch.core.f2p import F2PFormat
from repro_torch.kernels import f2p_attention as TA
from repro_torch.kernels import f2p_matmul as TM

FMT = (8, 2, "sr", True)     # the serve path's default KV format
S_LONG, T = 40960, 8


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


def _old_plan(B, K, R, hd, S):
    """The plan's arithmetic before caches past 32768 positions: 128
    positions per CTA, 3 or 4 rows per CTA."""
    groups = -(-R // 4)
    rows = max(3, -(-R // groups))
    nsplit = max(1, -(-S // 128))
    many = nsplit > 1
    return (rows, groups, nsplit, (nsplit, K * groups, B),
            B * K * groups * nsplit * (rows * hd + 2 * rows) if many else 0,
            B * K * groups if many else 0)


@pytest.mark.parametrize("S", [32769, 131072, 524288])
@pytest.mark.parametrize("K,R", [(8, 3), (8, 8)])
def test_attention_plan_covers_any_cache_length(S, K, R):
    """llama3.2-3b's (8, 3) and jamba's (8, 8) at 257 splits, Llama 3.2's
    published context and the reference's long_500k: the grid covers S and
    the split workspace holds one partial per split."""
    for tile in (TA.ATTN_SPLIT, 512):
        p = TA.attention_plan(1, K, R, 128, S, tile)
        assert p.tile == tile and p.nsplit == -(-S // tile)
        assert p.nsplit * tile >= S > (p.nsplit - 1) * tile
        assert p.grid == (p.nsplit, K * p.groups, 1)
        assert p.n_part == K * p.groups * p.nsplit * (p.rows * 128
                                                      + 2 * p.rows)
    # at jamba's long_500k a 512 tile divides the merge by 4
    assert TA.attention_plan(1, 8, 8, 128, 524288).nsplit == 4096
    assert TA.attention_plan(1, 8, 8, 128, 524288, 512).nsplit == 1024


@pytest.mark.parametrize("B,K,R,hd", [(8, 8, 3, 128), (1, 8, 8, 128),
                                      (3, 2, 12, 64), (2, 40, 1, 64)])
def test_default_plan_up_to_32768_is_unchanged(B, K, R, hd):
    for S in (1, 127, 128, 129, 1024, 8191, 32767, 32768):
        assert tuple(TA.attention_plan(B, K, R, hd, S))[:6] == _old_plan(
            B, K, R, hd, S)
    assert TA.attention_plan(B, K, R, hd, 1024).tile == TA.ATTN_SPLIT


def test_grid_limits_raise_by_name():
    with pytest.raises(ValueError, match="grid"):
        TA.attention_plan(65536, 8, 3, 128, 1024)
    with pytest.raises(ValueError, match="tile"):
        TA.attention_plan(1, 8, 3, 128, 1024, 2 ** 21)


def _long_inputs(K, seed):
    rng = np.random.default_rng(seed)
    G = 3
    q = rng.normal(size=(1, 1, K * G, 32)).astype(np.float32)
    k = rng.normal(size=(1, S_LONG, K, 32)).astype(np.float32)
    v = rng.normal(size=(1, S_LONG, K, 32)).astype(np.float32)

    def both(x):
        jq = QT.quantize(jnp.asarray(x), JF2PFormat(*FMT), block=32,
                         backend="xla", packed=True)
        tq = TQ.quantize(torch.from_numpy(x), F2PFormat(*FMT), block=32,
                         packed=True)
        return jq, tq

    return q, both(k), both(v)


@pytest.mark.parametrize("K", [1, 2])
def test_plain_attention_at_40960_matches_reference(K):
    """Dense and paged over the same cache, at kv_len S - 1 and 100."""
    q, (jk, tk), (jv, tv) = _long_inputs(K, seed=K)
    maxp = S_LONG // T
    rng = np.random.default_rng(10 + K)
    perm = rng.permutation(maxp + 1)[:maxp].astype(np.int32)
    for kv_len in (S_LONG - 1, 100):
        want = np.asarray(JA.attention_packed(
            jnp.asarray(q), jk, jv, kv_len=kv_len, backend="xla"))
        got = TA.attention_packed(torch.from_numpy(q), tk, tv, kv_len=kv_len)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

        # the same cache as pool slabs through a shuffled page table
        def slab(jx, tx):
            jc = jnp.zeros((maxp + 1, T) + jx.codes.shape[2:], jx.codes.dtype)
            js = jnp.zeros((maxp + 1, T) + jx.scales.shape[2:],
                           jx.scales.dtype)
            jc = jc.at[perm].set(jx.codes.reshape((maxp, T)
                                                  + jx.codes.shape[2:]))
            js = js.at[perm].set(jx.scales.reshape((maxp, T)
                                                   + jx.scales.shape[2:]))
            jsl = QT.QTensor.from_parts(jc, js, jx.fmt, jx.block,
                                        (maxp + 1, T, K, 32), packed=True)
            tsl = TQ.QTensor.from_parts(
                torch.from_numpy(np.array(jc)),
                torch.from_numpy(np.array(js)), tx.fmt, tx.block,
                (maxp + 1, T, K, 32), packed=True)
            return jsl, tsl

        (jks, tks), (jvs, tvs) = slab(jk, tk), slab(jv, tv)
        pages = perm[None]
        wantp = np.asarray(JA.attention_paged_reference(
            jnp.asarray(q), jks, jvs, jnp.asarray(pages), kv_len=kv_len))
        tp = torch.from_numpy(pages)
        gotp = TA.attention_paged(torch.from_numpy(q), tks, tvs, tp,
                                  kv_len=kv_len)
        np.testing.assert_allclose(gotp.numpy(), wantp, rtol=1e-5, atol=1e-5)
        assert torch.equal(gotp, got)        # the same words, the same loop
        span = -(-kv_len // 128) * 128 // T  # whole tiles of the live span
        assert torch.equal(TA.attention_paged(
            torch.from_numpy(q), tks, tvs, tp[:, :span].contiguous(),
            kv_len=kv_len), got)
