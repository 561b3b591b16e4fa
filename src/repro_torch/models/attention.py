"""GQA attention: naive and chunked train / prefill attention,
the packed F2P KV cache and the decode branches (port of
``repro.models.attention``).

Shapes: x [B, S, D]; q [B, S, H, hd]; k/v [B, S, K, hd] with H % K == 0.
A cache is ``{"k", "v"}`` holding either dense tensors ``[B, Smax, K, hd]``
or packed :class:`~repro_torch.core.qtensor.QTensor` s (uint32 words
``[B, Smax, K, W]`` + per-(position, head) f32 scales, block = head_dim).
Where the reference returns updated caches from pure functions (and the
engine donates the buffers), the port writes the new KV into the cache or
pool-slab storage IN PLACE (packed caches through ``f2p_kv_write``, dense
ones by ``index_put_``/``copy_``) and returns the same objects; the unfused
decode reads a packed cache back through ``f2p_kv_read``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import qtensor as QT
from repro_torch.core.f2p import F2PFormat, Flavor
from repro_torch.core.qtensor import QTensor
from repro_torch.kernels.bits import pack_bits_np
from repro_torch.kernels.f2p_attention import attention_packed, attention_paged
from repro_torch.kernels.f2p_quant import f2p_kv_read, f2p_kv_write
from repro_torch.models import parallel as TP
from repro_torch.models.common import apply_rope
from repro_torch.models.sharding import constrain

KV_FMT = F2PFormat(n_bits=8, h_bits=2, flavor=Flavor.SR, signed=True)


def quantize_kv(k: torch.Tensor, fmt: F2PFormat = KV_FMT) -> QTensor:
    return QT.quantize(k, fmt, block=k.shape[-1], packed=True)


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------
def _len_mask(Sk: int, kv_len, device):
    """Additive 0/-inf mask over positions >= kv_len: scalar -> [Sk],
    per-batch [B] -> [B, Sk]."""
    kl = torch.as_tensor(kv_len, device=device)
    ar = torch.arange(Sk, device=device)
    return torch.where(ar < kl[..., None], 0.0, -math.inf)


def naive_attention(q, k, v, *, causal: bool, q_offset=0, kv_len=None):
    """Full-materialization GQA attention (einsum + softmax, as the
    reference's prefill path)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    # sqrt(hd) rounded f32 -> q's dtype, as the reference divides by it
    root = float(torch.tensor(math.sqrt(hd), dtype=torch.float32).to(q.dtype))
    scores = (torch.einsum("bqkgd,bskd->bkgqs", qg, k) / root).to(
        torch.float32)
    mask = torch.zeros((Sq, Sk), dtype=torch.float32, device=q.device)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        mask = torch.where(kpos <= qpos, 0.0, -math.inf)
    if kv_len is not None:
        lm = _len_mask(Sk, kv_len, q.device)
        mask = mask + lm if lm.ndim == 1 else mask + lm[:, None, None, None, :]
    probs = torch.softmax(scores + mask, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, hd)


def chunked_attention(q, k, v, *, causal: bool, chunk: int, q_offset=0,
                      kv_len=None):
    """Online-softmax GQA attention over KV chunks of ``chunk`` positions
    (the reference's ``chunked_attention``): K and V are zero-padded to
    whole chunks, the running max ``m`` and sum ``l`` are f32, the
    accumulator is in q's dtype, and a row that no position of a chunk
    reaches is guarded (its max stays -inf, its terms 0). ``kv_len`` is a
    scalar: positions at or past it are masked. A Python loop over the
    chunks, differentiable through autograd. In a no-grad call (prefill)
    the live scores are ``[B, K, G, Sq, chunk]``; under autograd every
    chunk's scores and probabilities are saved for the backward, so a
    train step holds as much as the naive path's."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    nchunk = -(-Sk // chunk)
    pad = nchunk * chunk - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qg = q.reshape(B, Sq, K, G, hd)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    limit = torch.as_tensor(Sk if kv_len is None else kv_len,
                            device=q.device)
    # the reference scales the f32 scores by jnp.sqrt(hd), an f32 number
    root = torch.tensor(math.sqrt(hd), dtype=torch.float32)
    acc = torch.zeros((B, K, G, Sq, hd), dtype=q.dtype, device=q.device)
    m = torch.full((B, K, G, Sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=q.device)
    for ci in range(nchunk):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg, kb).to(
            torch.float32) / root
        kpos = ci * chunk + torch.arange(chunk, device=q.device)
        valid = kpos[None, :] < limit
        if causal:
            valid = valid & (kpos[None, :] <= qpos[:, None])
        scores = torch.where(valid, scores, -math.inf)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(scores - safe_m[..., None])
        corr = torch.exp(torch.where(torch.isfinite(m), m - safe_m,
                                     -math.inf))
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(q.dtype), vb)
        acc = acc * corr[..., None].to(q.dtype) + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-37)[..., None].to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def _broadcast_kv(k, H: int):
    """[B, S, K, hd] -> [B, S, H, hd], each KV head repeated H // K times:
    the head-sharded path's single merged head axis (``opt_head_shard``)."""
    B, S, K, hd = k.shape
    return k[:, :, :, None].expand(B, S, K, H // K, hd).reshape(B, S, H, hd)


def _mha_attention(q, k, v, *, causal: bool, q_offset=0, kv_len=None):
    """Head-sharded attention: q/k/v all [B, S, H, hd], the head axis
    pinned to the model axis, so the scores stay local to a head shard."""
    q = constrain(q, ("batch", None, "heads", None))
    k = constrain(k, ("batch", None, "heads", None))
    v = constrain(v, ("batch", None, "heads", None))
    Sq, Sk, hd = q.shape[1], k.shape[1], q.shape[-1]
    # the reference divides the f32 scores by jnp.sqrt(hd), an f32 number
    root = torch.tensor(math.sqrt(hd), dtype=torch.float32)
    scores = torch.einsum("bqhd,bshd->bhqs", q, k).to(torch.float32)
    scores = constrain(scores / root, ("batch", "heads", None, None))
    mask = torch.zeros((Sq, Sk), dtype=torch.float32, device=q.device)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        mask = torch.where(kpos <= qpos, 0.0, -math.inf)
    if kv_len is not None:
        lm = _len_mask(Sk, kv_len, q.device)
        mask = mask + lm if lm.ndim == 1 else mask + lm[:, None, None, :]
    probs = torch.softmax(scores + mask, dim=-1).to(q.dtype)
    out = torch.einsum("bhqs,bshd->bqhd", probs, v)
    return constrain(out, ("batch", None, "heads", None))


def _mha_chunked(q, k, v, *, causal: bool, chunk: int, q_offset=0,
                 kv_len=None):
    """Head-sharded online-softmax attention over KV chunks (the
    reference's ``_mha_chunked``; :func:`chunked_attention`'s arithmetic
    on the merged head axis)."""
    q = constrain(q, ("batch", None, "heads", None))
    k = constrain(k, ("batch", None, "heads", None))
    v = constrain(v, ("batch", None, "heads", None))
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    nchunk = -(-Sk // chunk)
    pad = nchunk * chunk - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qpos = q_offset + torch.arange(Sq, device=q.device)
    limit = torch.as_tensor(Sk if kv_len is None else kv_len,
                            device=q.device)
    root = torch.tensor(math.sqrt(hd), dtype=torch.float32)
    acc = torch.zeros((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    for ci in range(nchunk):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        s = torch.einsum("bqhd,bshd->bhqs", q, kb).to(torch.float32) / root
        kpos = ci * chunk + torch.arange(chunk, device=q.device)
        valid = kpos[None, :] < limit
        if causal:
            valid = valid & (kpos[None, :] <= qpos[:, None])
        s = torch.where(valid, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - safe_m[..., None])
        corr = torch.exp(torch.where(torch.isfinite(m), m - safe_m,
                                     -math.inf))
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqs,bshd->bhqd", p.to(q.dtype), vb)
        acc = acc * corr[..., None].to(q.dtype) + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-37)[..., None].to(q.dtype)
    return out.transpose(1, 2)


def _attend(q, k, v, cfg, *, causal, kv_len=None, q_offset=0):
    """The train / prefill / unfused-decode attention of ``cfg`` (the
    reference's dispatch): with ``opt_head_shard`` KV is broadcast to every
    query head and attended head-sharded; chunked when ``cfg.attn_impl ==
    "chunked"`` and more than one query position is attended, else
    naive."""
    if cfg.opt_head_shard:
        k = _broadcast_kv(k, q.shape[2])
        v = _broadcast_kv(v, q.shape[2])
        if cfg.attn_impl == "chunked" and q.shape[1] > 1:
            return _mha_chunked(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                                q_offset=q_offset, kv_len=kv_len)
        return _mha_attention(q, k, v, causal=causal, q_offset=q_offset,
                              kv_len=kv_len)
    if cfg.attn_impl == "chunked" and q.shape[1] > 1:
        return chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                                 q_offset=q_offset, kv_len=kv_len)
    return naive_attention(q, k, v, causal=causal, q_offset=q_offset,
                           kv_len=kv_len)


# ---------------------------------------------------------------------------
# Block-level apply
# ---------------------------------------------------------------------------
def attention_apply(p: dict, x, cfg, *, mode: str, cache=None, pos_offset=0,
                    cross_kv=None, causal=True, pages=None):
    """mode: 'train' | 'prefill' | 'decode'. Returns (out, cache).

    ``train`` is attention over the sequence with no cache (naive or
    chunked by ``cfg.attn_impl``, differentiable through autograd), causal
    unless ``causal=False`` (the encoder).

    ``cross_kv`` (``[B, Se, D]``, the encoder's output): cross-attention,
    whatever the mode. K and V are projected from ``cross_kv`` at every
    call, attention is non-causal over all ``Se`` positions with no length
    mask, and ``cache`` is returned untouched.

    ``pages`` (decode only): a ``[B, max_pages]`` int32 page table; ``cache``
    is then one layer's pool slab (``{"k","v"}`` QTensors, codes
    ``[n_pages, page_tokens, K, words]``). The new token's KV is quantized
    and written into the slab page holding position ``pos_offset`` and
    attention reads the slabs through the table (``attention_paged``).

    Weights holding fewer than ``cfg.n_heads`` query heads are this model
    rank's heads (``train``, the sharded step): ``wq`` / ``wk`` / ``wv``
    columns and ``wo`` rows of its query heads and the KV heads they read.
    The rank attends those heads, and the partial output of ``wo`` is
    summed over the model axis."""
    B, S, D = x.shape
    hd = cfg.head_dim
    H, K = p["wq"].shape[1] // hd, p["wk"].shape[1] // hd
    split = H != cfg.n_heads
    leg = "train.tp_cross" if cross_kv is not None else "train.tp_attn"
    if split:
        x = TP.to_model(x, leg)
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    if cross_kv is not None:
        Se = cross_kv.shape[1]
        if split:
            cross_kv = TP.to_model(cross_kv, "train.tp_cross_kv")
        k = (cross_kv @ p["wk"]).reshape(B, Se, K, hd)
        v = (cross_kv @ p["wv"]).reshape(B, Se, K, hd)
        out = _attend(q, k, v, cfg, causal=False)
        out = out.reshape(B, S, H * hd) @ p["wo"]
        return (TP.from_model(out, leg) if split else out), cache
    k = (x @ p["wk"]).reshape(B, S, K, hd)
    v = (x @ p["wv"]).reshape(B, S, K, hd)
    # an int stays an int (no device round trip per layer); a [B] tensor
    # carries per-slot offsets -> positions [B, S]
    pos = pos_offset
    if cfg.pos == "rope":       # pos="none": the mixers carry position
        positions = torch.arange(S, device=x.device)
        if isinstance(pos, torch.Tensor) and pos.ndim:
            positions = pos[:, None] + positions
        else:
            positions = positions + int(pos)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if mode == "train":
        out = _attend(q, k, v, cfg, causal=causal)
    elif mode == "prefill":
        _cache_write(cache, k, v, 0)
        out = _attend(q, k, v, cfg, causal=causal)
    elif mode == "decode":
        assert S == 1
        if pages is not None:
            _paged_cache_write(cache, k, v, pos, pages)
            out = attention_paged(q, cache["k"], cache["v"], pages,
                                  kv_len=pos + 1)
        else:
            _cache_write(cache, k, v, pos)
            if cfg.fused_attention and isinstance(cache["k"], QTensor):
                out = attention_packed(q, cache["k"], cache["v"],
                                       kv_len=pos + 1)
            else:
                kc, vc = _cache_read(cache, cfg)
                out = _attend(q, kc, vc, cfg, causal=False, kv_len=pos + 1)
    else:
        raise ValueError(mode)
    out = out.reshape(B, S, H * hd) @ p["wo"]
    return (TP.from_model(out, leg) if split else out), cache


# ---------------------------------------------------------------------------
# Cache plumbing
# ---------------------------------------------------------------------------
def zero_code_row(fmt: F2PFormat, hd: int) -> np.ndarray:
    """One packed head_dim row of the code of VALUE zero (flavor-dependent:
    0 for SR/SI, the top payload code for LR/LI): with unit scales an empty
    slot decodes to exact 0.0."""
    zero_code = int(fmt.encode_nearest(np.zeros(1))[0])
    return pack_bits_np(np.full((hd,), zero_code, np.uint32), fmt.n_bits)


def empty_packed(shape, fmt: F2PFormat, device) -> QTensor:
    """Materialized zero-code packed cache of logical ``shape[..., hd]``."""
    hd = shape[-1]
    row = torch.from_numpy(zero_code_row(fmt, hd).view(np.int32)).to(device)
    codes = row.expand(*shape[:-1], row.numel()).contiguous()
    return QTensor.from_parts(
        codes.view(torch.uint32),
        torch.ones(*shape[:-1], 1, dtype=torch.float32, device=device),
        fmt, hd, shape, packed=True)


def init_cache(cfg, batch: int, max_seq: int, quantized: bool, dtype,
               device, fmt: F2PFormat = KV_FMT, lead: tuple = ()):
    """``{"k","v"}`` cache ``[*lead, batch, max_seq, K, hd]``: packed
    zero-code QTensors when ``quantized``, else zero tensors of ``dtype``."""
    shape = (*lead, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    if quantized:
        return {kv: empty_packed(shape, fmt, device) for kv in ("k", "v")}
    return {kv: torch.zeros(shape, dtype=dtype, device=device)
            for kv in ("k", "v")}


def _cache_write(cache, k, v, idx):
    """Write k/v ``[B, S, K, hd]`` at token position ``idx`` (an int, or a
    per-slot ``[B]`` tensor), in place: a packed cache in one
    :func:`f2p_kv_write` (B3 on the card: K and V, one launch), a dense one
    by copy."""
    if isinstance(cache["k"], QTensor):
        f2p_kv_write(k, v, cache, idx)
        return
    for name, x in (("k", k), ("v", v)):
        c = cache[name]
        src = x.to(c.dtype)
        if isinstance(idx, torch.Tensor) and idx.ndim:   # per-slot [B]
            B, S = x.shape[0], x.shape[1]
            rows = torch.arange(B, device=k.device)[:, None]
            cols = idx[:, None].to(torch.int64) + torch.arange(
                S, device=k.device)
            c[rows, cols] = src
        else:
            start, n = int(idx), x.shape[1]
            c[:, start:start + n].copy_(src)


def _paged_cache_write(cache, k, v, pos, pages):
    """Decode write straight into the pool slabs: the new token's k/v
    ``[B, 1, K, hd]`` are quantized into slab page ``pages[b, pos // T]`` at
    offset ``pos % T``, in one :func:`f2p_kv_write`. The page index is
    clamped to the table (retired slots point at the dump page, whose
    contents are never read)."""
    f2p_kv_write(k, v, cache, pos, pages)


def _cache_read(cache, cfg):
    """Dense k/v of a cache: a packed cache is dequantized whole, K and V in
    one :func:`f2p_kv_read` (B4 on the card: one launch), the unfused path
    the fused kernel replaces."""
    if isinstance(cache["k"], QTensor):
        return f2p_kv_read(cache, cfg.torch_dtype)
    return cache["k"], cache["v"]
