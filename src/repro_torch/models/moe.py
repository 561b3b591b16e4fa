"""Token-choice top-k MoE with sort-based capacity dispatch (port of
``repro.models.moe``, step for step).

The router runs in f32 whatever the model's dtype. Each token picks its k
most probable experts (ties go to the lower expert index, as
``lax.top_k``), gates are renormalised over the k picks, and the (token,
expert) assignments are stably sorted by expert: an assignment's slot is
its rank inside its expert's run, and every slot at or past the capacity
``round(T * k / E * capacity_factor)`` (Python's ``round`` on host
numbers) is dropped onto a dump row. The experts then run as three batched
products over ``[E, cap, D]``, and the kept outputs, times their gates,
are added back onto their tokens in ``x.dtype`` in the reference's order
(by expert), before the shared expert's SwiGLU. Every token of ``x`` is
routed, padding and idle decode slots included: they take capacity as the
reference's do.

``load`` counts every assignment, dropped ones included, and carries no
gradient; ``aux_loss`` is the Switch-style balance term.

Expert parallel (the sharded step): a model rank that holds ``E / m`` of
the experts routes every token as the others do (the router is
replicated, so ``load``, the drops and ``aux_loss`` are the one-process
run's), runs its experts over their slots of the dispatch buffer, and the
combine's partial sums are added over the model axis.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import parallel as TP
from repro_torch.models.common import swiglu

def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class SharedExpert(nn.Module):
    def __init__(self, D: int, F: int, dtype, device):
        super().__init__()
        self.gate = _param((D, F), dtype, device)
        self.up = _param((D, F), dtype, device)
        self.down = _param((F, D), dtype, device)


class MoE(nn.Module):
    """The parameters of one MoE FF: an f32 router ``[D, E]``, the experts'
    ``gate``/``up`` ``[E, D, F]`` and ``down`` ``[E, F, D]``, and with
    ``n_shared_experts`` a shared SwiGLU of width ``n_shared * F``."""

    def __init__(self, cfg, device):
        super().__init__()
        D, F, E, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.torch_dtype
        self.router = _param((D, E), torch.float32, device)
        self.gate = _param((E, D, F), dt, device)
        self.up = _param((E, D, F), dt, device)
        self.down = _param((E, F, D), dt, device)
        self.shared = (SharedExpert(D, cfg.n_shared_experts * F, dt, device)
                       if cfg.n_shared_experts else None)

    def init_order(self) -> list[tuple[nn.Parameter, float]]:
        """(parameter, init scale) in the reference's draw order."""
        out = [(self.router, 0.01), (self.gate, 0.02), (self.up, 0.02),
               (self.down, 0.02)]
        if self.shared is not None:
            out += [(self.shared.gate, 0.02), (self.shared.up, 0.02),
                    (self.shared.down, 0.02)]
        return out

    def forward(self, x, cfg, sp: bool = False):
        """:func:`moe_apply` (a forward hook sees each call's ``load``)."""
        return moe_apply(self, x, cfg, sp=sp)


def capacity(T: int, cfg) -> int:
    """Slots per expert for ``T`` tokens, the reference's host arithmetic
    (Python's banker's ``round``)."""
    k, E = cfg.experts_per_token, cfg.n_experts
    return int(max(1, round(T * k / E * cfg.capacity_factor)))


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, ties to the
    lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p: MoE, x: torch.Tensor, cfg, sp: bool = False):
    """x ``[B, S, D]`` -> (out ``[B, S, D]``, {"load": [E] f32, "aux_loss"}).
    ``sp``: the caller runs sequence parallelism, and the shared expert's
    hidden activations stay unpinned (the reference's flag)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    T = B * S
    dev = x.device
    xf = x.reshape(T, D)

    logits = xf.to(torch.float32) @ p.router
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = top_k(probs, k)                       # [T, k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # ---- sort-based dispatch -------------------------------------------
    cap = capacity(T, cfg)
    flat_e = expert_idx.reshape(-1)                            # [T*k]
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    flat_g = gates.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    # slot of each assignment within its expert's run
    first_of_expert = torch.searchsorted(
        se, torch.arange(E, device=dev, dtype=se.dtype), side="left")
    slot = torch.arange(T * k, device=dev) - first_of_expert[se]
    keep = slot < cap
    dest = torch.where(keep, se * cap + slot, E * cap)         # drops -> dump

    # a model rank holding El < E experts (the sharded step) dispatches
    # into its own experts' slots only: the rest are its dump row
    El = p.gate.shape[0]
    split, xe = El != E, xf
    if split:
        xe = TP.to_model(xf, "train.tp_moe")
        sg = TP.to_model(sg, "train.tp_moe_gates")
        dest = dest - TP.model_rank() * El * cap
        keep = keep & (dest >= 0) & (dest < El * cap)
        dest = torch.where(keep, dest, El * cap)
    gathered = torch.zeros((El * cap + 1, D), dtype=x.dtype, device=dev)
    gathered[dest] = xe[st]
    ein = gathered[:-1].reshape(El, cap, D)

    # ---- expert computation (one batched product per matrix) -----------
    g = torch.bmm(ein, p.gate)
    u = torch.bmm(ein, p.up)
    h = torch.bmm(torch.nn.functional.silu(g) * u, p.down)

    # ---- combine ---------------------------------------------------------
    hflat = h.reshape(El * cap, D)
    picked = torch.where(keep[:, None],
                         hflat[torch.clamp(dest, max=El * cap - 1)],
                         torch.zeros((), dtype=h.dtype, device=dev))
    contrib = picked * sg[:, None].to(x.dtype)
    # the reference's scatter-add adds each token's k parts onto zeros in
    # sorted (expert) order; summing them in that order keeps the same
    # roundings and no atomics decide it
    back = torch.empty_like(contrib)
    back[order] = contrib
    back = back.reshape(T, k, D)
    if k > 1:
        rank = torch.argsort(expert_idx, dim=-1)
        back = torch.gather(back, 1, rank[..., None].expand(T, k, D))
    out = torch.zeros((T, D), dtype=x.dtype, device=dev)
    for j in range(k):
        out = out + back[:, j]
    if split:
        out = TP.from_model(out, "train.tp_moe")

    if p.shared is not None:
        sh = p.shared
        out = out + swiglu(xf, sh.gate, sh.up, sh.down, constrain_ff=not sp,
                           split=sh.down.shape[0] != cfg.n_shared_experts *
                           cfg.d_ff, leg="train.tp_shared")

    # load-balancing aux (Switch-style) + per-expert token load; the counts
    # are not differentiated. A scatter-add of ones, exact in f32 in any
    # order (bincount would wait on the device for its output size)
    ones = torch.ones((T * k,), dtype=torch.float32, device=dev)
    load = torch.zeros((E,), dtype=torch.float32, device=dev).index_add_(
        0, flat_e.detach(), ones)
    imp = probs.mean(dim=0)
    aux_loss = E * torch.sum(imp * (load / torch.clamp(load.sum(), min=1.0)))
    return out.reshape(B, S, D), {"load": load, "aux_loss": aux_loss}


def dropped(cap: int, load: torch.Tensor) -> torch.Tensor:
    """Assignments past capacity under ``load``: sum(max(load - cap, 0))."""
    return torch.clamp(load - cap, min=0).sum()
