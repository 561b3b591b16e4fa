"""Mamba-1 selective SSM block (port of ``repro.models.ssm``).

The recurrence ``h_t = dA_t * h_{t-1} + dB_t x_t`` runs as the
reference's *chunked* scan: chunks of ``SCAN_CHUNK`` steps carry ``h`` from
one to the next, so live memory is O(B * Q * d_inner * N) instead of
O(B * S * d_inner * N). A sequence of at most one chunk is scanned whole;
a longer one must be a whole number of chunks (the reference asserts it,
and so there is no ragged path: the port raises for the same inputs).

Inside a chunk the reference calls ``jax.lax.associative_scan``; torch has
none, so :func:`_chunk_scan` runs a log-depth (Hillis–Steele) scan of the
``(a, b)`` pairs: log2(Q) passes, each combining every step with the one
``d`` before it. The products are the same, taken in another order, so an
f32 state differs from the reference's by a few ulps per pass (the tests
hold it within rtol = atol = 1e-5). Decode is the O(1) recurrent update.

All scan math is f32; the projections and the conv run in the model's
dtype, and ``a_log`` / ``d_skip`` are f32 leaves even in a bf16 model, as
the reference's. A cache is ``{"conv": [B, C-1, d_inner]`` (model dtype)
``, "ssm": [B, d_inner, N]`` (f32)``}``; prefill and decode read the
state from it and write the new state back IN PLACE.

Leaves of fewer than ``d_inner`` channels are this model rank's
(``train``, the sharded step): it scans its channels, and the x_proj and
out_proj products are summed over the model axis.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import parallel as TP

SCAN_CHUNK = 256


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Mamba(nn.Module):
    """The parameters of one mamba mixer, the reference's leaves and
    layouts (``x @ w``)."""

    def __init__(self, cfg, device):
        super().__init__()
        D, di, N, C = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
        dt_rank = max(D // 16, 1)
        dt = cfg.torch_dtype
        self.in_proj = _param((D, 2 * di), dt, device)
        self.conv_w = _param((C, di), dt, device)
        self.conv_b = _param((di,), dt, device)
        self.x_proj = _param((di, dt_rank + 2 * N), dt, device)
        self.dt_proj = _param((dt_rank, di), dt, device)
        self.dt_bias = _param((di,), dt, device)
        self.a_log = _param((di, N), torch.float32, device)
        self.d_skip = _param((di,), torch.float32, device)
        self.out_proj = _param((di, D), dt, device)

    def init_order(self) -> list[tuple[nn.Parameter, float]]:
        """(parameter, init scale) of the drawn leaves, in the reference's
        draw order."""
        return [(self.in_proj, 0.02), (self.conv_w, 0.1),
                (self.x_proj, 0.02), (self.dt_proj, 0.02),
                (self.out_proj, 0.02)]

    @torch.no_grad()
    def init_fixed(self):
        """The leaves the reference does not draw: a zero conv bias, dt
        bias softplus^-1(0.01) = -4.6, the S4D-real ``a_log`` (log of 1..N
        on every channel) and a unit skip."""
        N = self.a_log.shape[1]
        self.conv_b.zero_()
        self.dt_bias.fill_(-4.6)
        self.a_log.copy_(torch.from_numpy(np.log(np.arange(
            1, N + 1, dtype=np.float32))).expand_as(self.a_log))
        self.d_skip.fill_(1.0)

    def apply(self, x, cfg, *, mode, cache=None, pos_offset=0, pages=None):
        """The block's mixer call (the state carries the position)."""
        return mamba_apply(self, x, cfg, mode=mode, cache=cache)


def _ssm_params(p: Mamba, x1, cfg, split: bool = False):
    """x1 [B,S,di] (post conv + silu) -> (dA [B,S,di,N], dBx [B,S,di,N],
    C [B,S,N]), all f32. ``split``: x1 and the leaves are this model
    rank's channels; the x_proj product is summed over the model axis."""
    N = cfg.ssm_state
    dt_rank = max(cfg.d_model // 16, 1)
    xdbc = x1 @ p.x_proj
    if split:
        xdbc = TP.to_model(TP.from_model(xdbc, "train.tp_mamba_xproj"),
                          "train.tp_mamba_dbc")
    dt_low, B_, C_ = torch.split(xdbc, [dt_rank, N, N], dim=-1)
    dt = F.softplus((dt_low @ p.dt_proj).float() + p.dt_bias.float())
    A = -torch.exp(p.a_log.float())                                # [di,N]
    dA = torch.exp(dt[..., None] * A)
    dBx = (dt * x1.float())[..., None] * B_.float()[:, :, None, :]
    return dA, dBx, C_.float()


def _chunk_scan(dA, dBx, h0):
    """Scan of one chunk from entry state h0. dA/dBx [B,Q,di,N]; h0
    [B,di,N] -> (h_all [B,Q,di,N], h_last). Hillis–Steele over the pairs
    (a, b) with (a_l, b_l) . (a_r, b_r) = (a_l a_r, a_r b_l + b_r): after
    the pass of offset d each step holds the combination of the 2d steps
    ending at it."""
    a, b = dA, dBx
    Q, d = a.shape[1], 1
    while d < Q:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    h_all = a * h0[:, None] + b
    return h_all, h_all[:, -1]


def selective_scan(dA, dBx, C_, h0=None, chunk=SCAN_CHUNK):
    """Full-sequence scan via chunks. Returns (y [B,S,di], h_last
    [B,di,N]). Raises for a sequence longer than ``chunk`` that is not a
    whole number of chunks, as the reference does."""
    B, S, di, N = dA.shape
    if h0 is None:
        h0 = torch.zeros((B, di, N), dtype=torch.float32, device=dA.device)
    if S <= chunk:
        h_all, h_last = _chunk_scan(dA, dBx, h0)
        return torch.einsum("bsdn,bsn->bsd", h_all, C_), h_last
    if S % chunk:
        raise ValueError(f"seq {S} not a multiple of scan chunk {chunk}")
    h, ys = h0, []
    for c in range(0, S, chunk):
        h_all, h = _chunk_scan(dA[:, c:c + chunk], dBx[:, c:c + chunk], h)
        ys.append(torch.einsum("bsdn,bsn->bsd", h_all, C_[:, c:c + chunk]))
    return torch.cat(ys, dim=1), h


def _causal_conv(x1, w, b, carry=None):
    """Depthwise causal conv over seq. x1 [B,S,di]; w [C,di]; carry
    [B,C-1,di]. Returns (out [B,S,di], new carry): the window's products
    added one tap at a time, in the reference's order."""
    C = w.shape[0]
    if carry is None:
        carry = torch.zeros((x1.shape[0], C - 1, x1.shape[2]),
                            dtype=x1.dtype, device=x1.device)
    xp = torch.cat([carry, x1], dim=1)
    S = x1.shape[1]
    out = torch.zeros_like(x1)
    for i in range(C):
        out = out + xp[:, i:i + S] * w[i]
    out = out + b
    new_carry = xp[:, xp.shape[1] - (C - 1):] if C > 1 else carry
    return out, new_carry


def mamba_apply(p: Mamba, x, cfg, *, mode: str, cache=None):
    """x [B,S,D] -> out [B,S,D]. ``mode``: 'train' (no cache), 'prefill'
    or 'decode' (S == 1): the conv carry and the SSM state start from
    ``cache`` (zeros without one) and the new ones are written into it in
    place."""
    B, S, D = x.shape
    dl = p.conv_w.shape[1]
    split = dl != cfg.d_inner
    if split:
        # this model rank's channels: in_proj's columns are a contiguous
        # slice of [x1 | z], so the product is gathered and each rank
        # keeps its channels of both halves
        xz = TP.gather_model(TP.to_model(x, "train.tp_mamba") @ p.in_proj,
                            -1, "train.tp_mamba_in")
        r, di = TP.model_rank(), cfg.d_inner
        x1 = xz[..., r * dl:(r + 1) * dl]
        z = xz[..., di + r * dl:di + (r + 1) * dl]
    else:
        x1, z = (x @ p.in_proj).chunk(2, dim=-1)
    carry = cache["conv"] if cache is not None else None
    x1, new_conv = _causal_conv(x1, p.conv_w, p.conv_b, carry)
    x1 = F.silu(x1)

    dA, dBx, C_ = _ssm_params(p, x1, cfg, split)
    h0 = cache["ssm"] if cache is not None else None
    if mode == "decode":
        assert S == 1
        h = dA[:, 0] * h0 + dBx[:, 0]                          # [B,di,N]
        y = torch.einsum("bdn,bn->bd", h, C_[:, 0])[:, None]
        h_last = h
    else:
        y, h_last = selective_scan(dA, dBx, C_, h0=h0)
    y = y + p.d_skip * x1.float()
    y = y.to(x.dtype) * F.silu(z)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(h_last)
    out = y @ p.out_proj
    return TP.from_model(out, "train.tp_mamba") if split else out


def init_mamba_cache(cfg, batch: int, dtype, device, lead: tuple = ()):
    """Zero state ``[*lead, batch, ...]``: conv carry in ``dtype``, SSM
    state in f32."""
    return {"conv": torch.zeros((*lead, batch, cfg.ssm_conv - 1,
                                 cfg.d_inner), dtype=dtype, device=device),
            "ssm": torch.zeros((*lead, batch, cfg.d_inner, cfg.ssm_state),
                               dtype=torch.float32, device=device)}
