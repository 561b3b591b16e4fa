"""xLSTM blocks (port of ``repro.models.xlstm``): mLSTM (matrix memory,
chunkwise-parallel stabilised form for train and prefill, O(1) recurrent
decode) and sLSTM (scalar memory, a step per token with exponential-gating
stabilisation). Follows Beck et al. 2024 (arXiv:2405.04517).

mLSTM parallel form (stabilised), per chunk of ``MLSTM_CHUNK`` steps (one
chunk of the whole sequence when S is not a multiple of it):
    lf_t = logsigmoid(f~_t);  F_t = cumsum(lf)
    logD[t,s] = F_t - F_s + i~_s   (s <= t, else -inf)
    m_t = max_s logD[t,s];  D = exp(logD - m_t)
    S = (Q K^T / sqrt(d)) * D;  out_t = S V / max(|sum_s S[t,s]|, exp(-m_t))
with the state (C, n, m) carried from chunk to chunk.

sLSTM recurrence (per head, stabilised):
    m_t = max(lf_t + m_{t-1}, i~_t)
    i' = exp(i~ - m_t);  f' = exp(lf + m_{t-1} - m_t)
    c_t = f' c + i' z;  n_t = f' n + i';  h = o * c / n

The reference scans chunks and steps with ``lax.scan``; here they are
Python loops. The sLSTM input projection ``x @ w_in + bias`` is taken for
the whole sequence at once (the same rows as the reference's per-step
product), and the recurrence then loops over S. Caches (every leaf f32):
mLSTM ``{"C": [B,H,hd,hd], "n": [B,H,hd], "m": [B,H]}``, sLSTM ``{"c",
"n", "h", "m"}`` each ``[B, D]``; ``m`` starts at -1e30. Prefill and decode
start from the cache and write the new state back IN PLACE.

Leaves narrower than the config's are this model rank's (``train``, the
sharded step). An mLSTM rank runs its heads' recurrence (its columns of
q, k and v are gathered from the wqkv product, whose columns are a
contiguous slice of [q | k | v]) and the out_proj product is summed over
the model axis. An sLSTM rank computes its columns of the input
projection (``w_in``'s), gathered once over the sequence; the recurrence
mixes every head's state into every gate, so each rank runs it whole on
``r_blocks`` gathered once a call (the recurrent product is 1/H of the
input projection's FLOPs).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import parallel as TP

MLSTM_CHUNK = 256
M0 = -1e30


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
class MLSTM(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        D, H = cfg.d_model, cfg.n_heads
        di = cfg.mlstm_expand * D
        dt = cfg.torch_dtype
        self.wqkv = _param((D, 3 * di), dt, device)
        self.w_gates = _param((D, 2 * H), dt, device)
        self.b_gates = _param((2 * H,), dt, device)
        self.w_ogate = _param((D, di), dt, device)
        self.out_proj = _param((di, D), dt, device)

    def init_order(self) -> list[tuple[nn.Parameter, float]]:
        return [(self.wqkv, 0.02), (self.w_gates, 0.01),
                (self.w_ogate, 0.02), (self.out_proj, 0.02)]

    @torch.no_grad()
    def init_fixed(self):
        """Gate biases: 0 for the input gates, 3 for the forget gates."""
        H = self.b_gates.shape[0] // 2
        self.b_gates[:H].zero_()
        self.b_gates[H:].fill_(3.0)

    def apply(self, x, cfg, *, mode, cache=None, pos_offset=0, pages=None):
        """The block's mixer call (the state carries the position)."""
        return mlstm_apply(self, x, cfg, mode=mode, cache=cache)


def _mlstm_chunked(q, k, v, i_t, lf, state0=None, chunk=MLSTM_CHUNK):
    """Chunkwise-parallel stabilised mLSTM. q/k/v [B,S,H,hd] (k pre-scaled
    by 1/sqrt(hd)); i_t/lf [B,S,H] f32. Carries (C [B,H,hd,hd], n [B,H,hd],
    m [B,H]) over S/chunk chunks; within a chunk the quadratic form runs on
    [B,Q,Q,H]. Returns (h [B,S,H,hd] f32, (C, n, m))."""
    B, S, H, hd = q.shape
    dev = q.device
    if S % chunk:
        chunk = S      # one chunk for short / ragged sequences
    if state0 is None:
        C0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=dev)
        n0 = torch.zeros((B, H, hd), dtype=torch.float32, device=dev)
        m0 = torch.full((B, H), M0, dtype=torch.float32, device=dev)
    else:
        C0, n0, m0 = state0["C"], state0["n"], state0["m"]
    q, k, v = q.float(), k.float(), v.float()
    tpos = torch.arange(chunk, device=dev)
    mask = (tpos[None, :, None, None] >= tpos[None, None, :, None])
    hs = []
    for c in range(0, S, chunk):
        qc, kc, vc = q[:, c:c + chunk], k[:, c:c + chunk], v[:, c:c + chunk]
        ic, lfc = i_t[:, c:c + chunk], lf[:, c:c + chunk]
        Fc = torch.cumsum(lfc, dim=1)                         # [B,Q,H]
        logD = Fc[:, :, None, :] - Fc[:, None, :, :] + ic[:, None, :, :]
        logD = torch.where(mask, logD, -math.inf)
        m_intra = torch.amax(logD, dim=2)                     # [B,Q,H]
        m_inter = Fc + m0[:, None, :]
        m_t = torch.maximum(m_intra, m_inter)
        Dm = torch.exp(logD - m_t[:, :, None, :])
        scores = torch.einsum("bthd,bshd->btsh", qc, kc) * Dm
        w_inter = torch.exp(m_inter - m_t)                    # [B,Q,H]
        num = torch.einsum("btsh,bshd->bthd", scores, vc) + \
            w_inter[..., None] * torch.einsum("bthd,bhde->bthe", qc, C0)
        den = scores.sum(dim=2) + w_inter * torch.einsum("bthd,bhd->bth",
                                                         qc, n0)
        den = torch.maximum(torch.abs(den), torch.exp(-m_t))
        hs.append(num / den[..., None])
        # chunk-exit state
        Ftot = Fc[:, -1]                                      # [B,H]
        m_src = Ftot[:, None, :] - Fc + ic                    # [B,Q,H]
        m_out = torch.maximum(Ftot + m0, torch.amax(m_src, dim=1))
        w_s = torch.exp(m_src - m_out[:, None, :])
        decay0 = torch.exp(Ftot + m0 - m_out)
        C0 = decay0[..., None, None] * C0 + \
            torch.einsum("bsh,bshd,bshe->bhde", w_s, kc, vc)
        n0 = decay0[..., None] * n0 + torch.einsum("bsh,bshd->bhd", w_s, kc)
        m0 = m_out
    h = hs[0] if len(hs) == 1 else torch.cat(hs, dim=1)
    return h, (C0, n0, m0)


def mlstm_apply(p: MLSTM, x, cfg, *, mode: str, cache=None):
    """x [B,S,D] -> out [B,S,D]; 'decode' (S == 1) is the recurrent
    update, 'train' / 'prefill' the chunkwise form (from the cache's state
    when there is one); the new state is written into ``cache``."""
    B, S, D = x.shape
    H = cfg.n_heads
    di = cfg.mlstm_expand * D
    hd = di // H
    gates = (x @ p.w_gates + p.b_gates).float()
    dl = p.w_ogate.shape[1]
    split = dl != di
    if split:
        # this model rank's heads: wqkv's columns are a contiguous slice
        # of [q | k | v], so the product is gathered and each rank keeps
        # its heads' columns of all three
        x = TP.to_model(x, "train.tp_mlstm")
        qkv = TP.gather_model(x @ p.wqkv, -1, "train.tp_mlstm_qkv")
        r = TP.model_rank()
        q, k, v = (qkv[..., j * di + r * dl:j * di + (r + 1) * dl]
                   for j in range(3))
        H = dl // hd
        gates = TP.to_model(gates, "train.tp_mlstm_gates").reshape(
            B, S, 2, -1)[..., r * H:(r + 1) * H].reshape(B, S, 2 * H)
    else:
        q, k, v = (x @ p.wqkv).chunk(3, dim=-1)
    # sqrt(hd) in f32, rounded to x's dtype, as the reference divides by it
    root = float(torch.tensor(math.sqrt(hd), dtype=torch.float32).to(x.dtype))
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, H, hd) / root
    v = v.reshape(B, S, H, hd)
    i_t, f_t = gates.chunk(2, dim=-1)                          # [B,S,H]
    lf = F.logsigmoid(f_t)

    if mode == "decode":
        assert S == 1 and cache is not None
        C, n, m = cache["C"], cache["n"], cache["m"]
        m_new = torch.maximum(lf[:, 0] + m, i_t[:, 0])         # [B,H]
        ip = torch.exp(i_t[:, 0] - m_new)
        fp = torch.exp(lf[:, 0] + m - m_new)
        k0, v0, q0 = k[:, 0].float(), v[:, 0].float(), q[:, 0].float()
        C = fp[..., None, None] * C + ip[..., None, None] * \
            torch.einsum("bhd,bhe->bhde", k0, v0)
        n = fp[..., None] * n + ip[..., None] * k0
        num = torch.einsum("bhd,bhde->bhe", q0, C)
        den = torch.abs(torch.einsum("bhd,bhd->bh", q0, n))
        h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
        h = h[:, None].to(x.dtype)                             # [B,1,H,hd]
        m = m_new
    else:
        h, (C, n, m) = _mlstm_chunked(q, k, v, i_t, lf, state0=cache)
        h = h.to(x.dtype)
    if cache is not None:
        cache["C"].copy_(C)
        cache["n"].copy_(n)
        cache["m"].copy_(m)
    og = torch.sigmoid(x @ p.w_ogate)
    out = (h.reshape(B, S, dl) * og) @ p.out_proj
    return TP.from_model(out, "train.tp_mlstm") if split else out


def init_mlstm_cache(cfg, batch: int, device, lead: tuple = ()):
    H = cfg.n_heads
    hd = cfg.mlstm_expand * cfg.d_model // H
    shape = (*lead, batch, H)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((*shape, hd, hd), **f32),
            "n": torch.zeros((*shape, hd), **f32),
            "m": torch.full(shape, M0, **f32)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
class SLSTM(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        D, H = cfg.d_model, cfg.n_heads
        hd = D // H
        dt = cfg.torch_dtype
        self.w_in = _param((D, 4 * D), dt, device)
        self.r_blocks = _param((H, hd, 4 * hd), dt, device)
        self.bias = _param((4 * D,), dt, device)

    def init_order(self) -> list[tuple[nn.Parameter, float]]:
        return [(self.w_in, 0.02), (self.r_blocks, 0.02)]

    @torch.no_grad()
    def init_fixed(self):
        self.bias.zero_()

    def apply(self, x, cfg, *, mode, cache=None, pos_offset=0, pages=None):
        """The block's mixer call (the state carries the position)."""
        return slstm_apply(self, x, cfg, mode=mode, cache=cache)


def _slstm_step(r_blocks, cfg, state, pre_t):
    """One step. state (c, n, h, m), each [B, D] f32; pre_t [B, 4D] the
    input projection ``x_t @ w_in + bias`` in the model's dtype; the
    recurrent blocks ``r_blocks`` [H, hd, 4hd]."""
    c, n, h, m = state
    B, D = c.shape
    H = cfg.n_heads
    hd = D // H
    hh = h.reshape(B, H, hd).to(r_blocks.dtype)
    rec = torch.einsum("bhd,hde->bhe", hh, r_blocks).reshape(B, 4 * D)
    z_t, i_t, f_t, o_t = (pre_t + rec).float().chunk(4, dim=-1)
    lf = F.logsigmoid(f_t)
    m_new = torch.maximum(lf + m, i_t)
    ip = torch.exp(i_t - m_new)
    fp = torch.exp(lf + m - m_new)
    c_new = fp * c + ip * torch.tanh(z_t)
    n_new = fp * n + ip
    h_new = torch.sigmoid(o_t) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, h_new, m_new


def slstm_apply(p: SLSTM, x, cfg, *, mode: str, cache=None):
    """x [B,S,D] -> out [B,S,D] (the h of every step), one step per token
    from the cache's state (zeros, m = -1e30, without one); the final
    state is written into ``cache``."""
    B, S, D = x.shape
    if cache is not None:
        state = (cache["c"], cache["n"], cache["h"], cache["m"])
    else:
        z = torch.zeros((B, D), dtype=torch.float32, device=x.device)
        state = (z, z, z, torch.full((B, D), M0, dtype=torch.float32,
                                     device=x.device))
    if mode == "decode":
        assert S == 1
    r_blocks = p.r_blocks
    if p.w_in.shape[1] != 4 * D:   # this model rank's gate-input columns
        pre = TP.gather_model_replicated(
            TP.to_model(x, "train.tp_slstm") @ p.w_in, -1,
            "train.tp_slstm_in") + p.bias
    else:
        pre = x @ p.w_in + p.bias                              # [B,S,4D]
    if r_blocks.shape[0] != cfg.n_heads:   # this model rank's heads' blocks
        r_blocks = TP.gather_model_replicated(r_blocks, 0, "train.tp_slstm_r")
    hs = []
    for t in range(S):
        state = _slstm_step(r_blocks, cfg, state, pre[:, t])
        hs.append(state[2])
    if cache is not None:
        for name, t in zip(("c", "n", "h", "m"), state):
            cache[name].copy_(t)
    return torch.stack(hs, dim=1).to(x.dtype)


def init_slstm_cache(cfg, batch: int, device, lead: tuple = ()):
    shape = (*lead, batch, cfg.d_model)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **f32), "n": torch.zeros(shape, **f32),
            "h": torch.zeros(shape, **f32), "m": torch.full(shape, M0, **f32)}
