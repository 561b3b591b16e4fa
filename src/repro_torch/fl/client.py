"""FL client: local SGD steps + error-feedback F2P-quantized delta (port of
``repro.fl.client``).

One fed-avg round, client side (Karimireddy et al. 2019 error feedback,
McMahan et al. 2017 local SGD):

    p_0 = global params
    p_t+1 = p_t - lr * grad(loss)(p_t, batch_t)        (local_steps times)
    delta = p_T - p_0 + residual                       (what SHOULD be sent)
    update = QTensor(delta)                            (what IS sent)
    residual' = delta - dequant(update)                (carried locally)

Parameters, deltas, residuals and updates are trees in the reference's
layout (nested dicts, the layers stacked ``[L, ...]`` under
``blocks/b0/...``: ``models.convert.stacked_params``), so every per-leaf
decision (``min_size``, the wire-shrink test, the policy's per-leaf format)
falls on the reference's leaves. The update holds a QTensor per
compressible leaf (float, size >= ``min_size``) and the raw f32 delta for
small leaves (norms, biases). On a CUDA tensor each quantize is one launch
of B5 (unpacked codes) or B3 (packed words), each residual's dequantize one
of B6 or B4; on the CPU the plain versions run.

The reference's ``lax.scan`` over the local steps is a Python loop, its
``jax.value_and_grad`` plain autograd on a copy of the leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import qtensor as QT
from repro_torch.core.f2p import F2PFormat, Flavor
from repro_torch.fl import _tree
from repro_torch.kernels.bits import packed_nbytes

FL_FMT = F2PFormat(n_bits=8, h_bits=2, flavor=Flavor.SR, signed=True)


@dataclasses.dataclass(frozen=True)
class ClientConfig:
    local_steps: int = 2
    lr: float = 0.1
    compress: bool = True
    fmt: F2PFormat = FL_FMT
    block: int = 128
    min_size: int = 1024
    error_feedback: bool = True
    policy: Any = None   # FormatPolicy | None: per-leaf format overrides
    # bit-packed update leaves on the wire (DESIGN.md §9): a 6-bit policy
    # format then really costs 6 bits/elem. None resolves through
    # QT.resolve_packed (unpacked: the port has no F2P_PACKED default).
    packed: bool | None = None
    # "pow2" rounds each block scale UP to a power of two, the contract
    # the exact integer aggregator's codes path needs (DESIGN.md §10).
    # "f32" keeps the tightest-fit scales (the server then folds them on
    # the deterministic fixed-point path, still order-invariant).
    scale_mode: str = "f32"


def leaf_wire_bytes(lead_rows: int, npad: int, block: int, fmt: F2PFormat,
                    packed: bool) -> int:
    """Wire bytes of one quantized leaf: codes + per-block f32 scales (the
    packed branch through the canonical ``kernels.bits.packed_nbytes``)."""
    if packed:
        code_bytes = packed_nbytes(npad, fmt.n_bits)
    else:
        code_bytes = npad * np.dtype(fmt.code_dtype).itemsize
    return lead_rows * (code_bytes + (npad // block) * 4)


def _compressible(p, ccfg: ClientConfig) -> bool:
    return p.numel() >= ccfg.min_size and p.is_floating_point()


def init_client_residuals(params, ccfg: ClientConfig):
    """Zero f32 residual per compressible leaf, ``None`` elsewhere."""
    if not (ccfg.compress and ccfg.error_feedback):
        return _tree.tree_map(lambda p: None, params)
    return _tree.tree_map(
        lambda p: (torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   if _compressible(p, ccfg) else None), params)


def leaf_formats(delta, ccfg: ClientConfig):
    """[(path_str, fmt, block)] per delta leaf, policy-resolved; the block
    is capped at the leaf's last dim (a 128-block on a 32-wide leaf would
    pad its codes 4x)."""
    from repro_torch.autotune.policy import leaf_path_str

    out = []
    for path, d in _tree.leaves_with_path(delta):
        p = leaf_path_str(path)
        fmt, blk = ccfg.fmt, ccfg.block
        if ccfg.policy is not None:
            fmt, blk = ccfg.policy.f2p_for(p, (fmt, blk))
        out.append((p, fmt, min(blk, d.shape[-1]) if d.ndim else blk))
    return out


def _quantize_delta(delta, residuals, ccfg: ClientConfig):
    """delta tree -> (update tree with QTensor leaves, new residuals)."""
    flat_d = _tree.leaves(delta)
    flat_r = _tree.leaves(residuals, keep_none=True)
    fmts = leaf_formats(delta, ccfg)
    packed = QT.resolve_packed(ccfg.packed)

    ups, res = [], []
    for d, r, (_, fmt, blk) in zip(flat_d, flat_r, fmts):
        if not (ccfg.compress and _compressible(d, ccfg)):
            ups.append(d)
            res.append(r)
            continue
        npad = -(-d.shape[-1] // blk) * blk
        wire = leaf_wire_bytes(d.numel() // d.shape[-1], npad, blk, fmt,
                               packed)
        if wire >= d.numel() * 4:
            # the codec would not shrink this leaf (e.g. [N, 1]: 1 B code +
            # 4 B scale per element vs 4 B raw): ship it raw
            ups.append(d)
            res.append(r)
            continue
        din = d + (r if r is not None else 0.0)
        qt = QT.quantize(din, fmt, block=blk, packed=packed,
                         scale_mode=ccfg.scale_mode)
        ups.append(qt)
        res.append(din - qt.dequantize(torch.float32) if r is not None
                   else r)
    return (_tree.unflatten(delta, ups),
            _tree.unflatten(residuals, res, keep_none=True))


def make_client_update(loss_fn, ccfg: ClientConfig):
    """The one-round client function.

    ``loss_fn(params, batch) -> scalar`` over a parameter tree. The returned
    function maps ``(global_params, residuals, batches)``, batches a dict of
    tensors stacked along a leading [local_steps] axis, to ``(update,
    new_residuals, losses)`` with ``losses`` a [local_steps] tensor."""

    def client_update(params, residuals, batches):
        p0 = _tree.leaves(params)
        p = [w.detach().clone().requires_grad_(True) for w in p0]
        losses = []
        for s in range(ccfg.local_steps):
            batch = {k: v[s] for k, v in batches.items()}
            loss = loss_fn(_tree.unflatten(params, p), batch)
            grads = torch.autograd.grad(loss, p)
            with torch.no_grad():
                p = [(w.to(torch.float32) - ccfg.lr * g.to(torch.float32))
                     .to(w.dtype).requires_grad_(True)
                     for w, g in zip(p, grads)]
            losses.append(loss.detach())
        with torch.no_grad():
            delta = _tree.unflatten(params, [
                a.to(torch.float32) - b.to(torch.float32)
                for a, b in zip(p, p0)])
            update, new_res = _quantize_delta(delta, residuals, ccfg)
        return update, new_res, torch.stack(losses)

    return client_update
