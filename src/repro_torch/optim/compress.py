"""F2P gradient compression with error feedback (port of
``repro.optim.compress``), on the canonical unpacked QTensor codec.

Each gradient leaf g with residual r is sent as q(g + r) and the residual
keeps what quantization lost, r' = (g + r) - q(g + r) (error feedback;
Karimireddy et al. 2019). ``_roundtrip`` is one ``quantize`` /
``dequantize`` pair of the unpacked codec: on a CUDA tensor it launches B5
then B6, one launch each per compressed leaf.

The port updates in place: the residual becomes g + r, then g + r - q, and
the gradient tensor receives q cast to its dtype. A leaf's temporaries are
its codes (1 byte per element) and the f32 round trip, never a second copy
of the whole tree. Leaf sizes are the reference's (stacked) leaf sizes
(``models.convert.reference_numel``), so ``min_size`` selects exactly the
leaves the reference compresses; leaves below it carry a ``None``
residual.

``compressed_psum`` is the reference's data-parallel wire path (reduce
scatter, quantize the shard, all-gather the codes); it needs several cards
and raises here (ROADMAP A12, sharded part). The reference's
``CompressionConfig.packed`` (bit-packed codes on that all-gather leg)
comes back with it: the single-card round trip is always unpacked.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import qtensor as QT
from repro_torch.core.f2p import F2PFormat, Flavor
from repro_torch.models.convert import reference_numel

GRAD_FMT = F2PFormat(n_bits=8, h_bits=2, flavor=Flavor.SR, signed=True)


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = True
    fmt: F2PFormat = GRAD_FMT
    block: int = 128
    error_feedback: bool = True
    min_size: int = 4096   # leaves smaller than this stay uncompressed


def _roundtrip(x: torch.Tensor, fmt: F2PFormat, block: int) -> torch.Tensor:
    """quantize + dequantize through the unpacked QTensor codec (any shape;
    last axis blocked and padded, leading dims kept): B5 then B6 on the
    card, the plain versions on the CPU."""
    qt = QT.quantize(x.to(torch.float32), fmt, block=block, packed=False)
    return qt.dequantize(torch.float32)


@torch.no_grad()
def compress_decompress(grads: dict, residuals: dict,
                        ccfg: CompressionConfig):
    """Error-feedback compression round trip over name -> tensor dicts, IN
    PLACE. Returns (grads, residuals), the same dicts."""
    if not ccfg.enabled:
        return grads, residuals
    if set(grads) != set(residuals):
        raise ValueError(
            f"gradient dict has {len(grads)} leaves but residual dict has "
            f"{len(residuals)}: the names must match leaf for leaf")
    sizes = reference_numel(grads)
    for name, g in grads.items():
        r = residuals[name]
        if sizes[name] < ccfg.min_size or r is None:
            if r is not None and r.shape != g.shape:
                raise ValueError(
                    f"{name}: residual shape {tuple(r.shape)} disagrees with "
                    f"uncompressed gradient {tuple(g.shape)}: stale "
                    "residuals?")
            continue
        if r.shape != g.shape:
            raise ValueError(
                f"{name}: residual shape {tuple(r.shape)} != gradient shape "
                f"{tuple(g.shape)}; residuals must be re-initialized when "
                "min_size changes")
        if ccfg.error_feedback:
            gin = r.add_(g)                  # r <- g + r
        else:
            gin = g.to(torch.float32)
        q = _roundtrip(gin, ccfg.fmt, ccfg.block)
        if ccfg.error_feedback:
            r.sub_(q)                        # r <- (g + r) - q(g + r)
        g.copy_(q)
    return grads, residuals


def init_residuals(params, ccfg: CompressionConfig) -> dict:
    """Zero f32 residuals for compressible leaves, ``None`` for small ones
    (never a broadcastable scalar)."""
    from repro_torch.optim.adamw import named_params

    named = named_params(params)
    sizes = reference_numel(named)
    return {n: (torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                if sizes[n] >= ccfg.min_size else None)
            for n, p in named.items()}


def compressed_psum(g: torch.Tensor, group, ccfg: CompressionConfig):
    """Mean-reduce ``g`` over a process group exchanging QTensor leaves on
    the gather leg (the reference's shard_map wire path)."""
    raise NotImplementedError(
        "compressed_psum needs several cards (torch.distributed reduce-"
        "scatter + all-gather of the codes): ROADMAP A12, sharded part")
