"""F2P gradient compression with error feedback (port of
``repro.optim.compress``), on the canonical unpacked QTensor codec.

Each gradient leaf g with residual r is sent as q(g + r) and the residual
keeps what quantization lost, r' = (g + r) - q(g + r) (error feedback;
Karimireddy et al. 2019); q is one quantize / dequantize pair of the
unpacked codec (blocks along the last axis, padded with zeros).

The port updates in place: the residual becomes g + r - q and the gradient
tensor receives q cast to its dtype. On the card a step's compressed leaves
go through ONE launch of B5's round-trip mode
(``kernels.f2p_quant.f2p_ef_roundtrip``): it reads g and r once and writes
both, codes and scales never leave registers, and there are no
temporaries. On the CPU each leaf runs the plain composition
(``ef_roundtrip_plain``), bitwise the same. Leaf sizes are the reference's
(stacked) leaf sizes (``models.convert.reference_numel``), so ``min_size``
selects exactly the leaves the reference compresses
(:func:`compressed_leaves`); leaves below it carry a ``None`` residual.
Every function here that sizes a leaf takes ``pattern_len``, the model's
``len(cfg.pattern)``: it decides how the per-layer names stack into the
reference's leaves (layer g·P + i is group g of ``blocks/b<i>``).

``compressed_psum`` is the reference's data-parallel wire path over a
process group: reduce-scatter the rows in the input dtype, quantize the
local sum shard (B5's codes mode on the card, B3 with
``CompressionConfig.packed``), fold the mean's 1/W into the scales,
all-gather codes and scales, and dequantize once (B6, or B4 when packed).
The round trip of the train step is always unpacked, as the reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.f2p import F2PFormat, Flavor
from repro_torch.kernels.f2p_quant import f2p_ef_roundtrip
from repro_torch.models.convert import reference_numel

GRAD_FMT = F2PFormat(n_bits=8, h_bits=2, flavor=Flavor.SR, signed=True)


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = True
    fmt: F2PFormat = GRAD_FMT
    block: int = 128
    error_feedback: bool = True
    min_size: int = 4096   # leaves smaller than this stay uncompressed
    # bit-packed codes on compressed_psum's all-gather leg (n_bits / 8
    # bytes an element); None is the unpacked default
    packed: bool | None = None


def compressed_leaves(grads: dict, residuals: dict, ccfg: CompressionConfig,
                      pattern_len: int) -> list:
    """The names of the leaves a step compresses, in order: those whose
    reference (stacked) leaf holds at least ``min_size`` elements and that
    carry a residual. Raises where the dicts' names or shapes disagree."""
    if set(grads) != set(residuals):
        raise ValueError(
            f"gradient dict has {len(grads)} leaves but residual dict has "
            f"{len(residuals)}: the names must match leaf for leaf")
    sizes = reference_numel(grads, pattern_len)
    names = []
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
        names.append(name)
    return names


@torch.no_grad()
def compress_decompress(grads: dict, residuals: dict,
                        ccfg: CompressionConfig, pattern_len: int):
    """Error-feedback compression round trip over name -> tensor dicts, IN
    PLACE. Returns (grads, residuals), the same dicts."""
    if not ccfg.enabled:
        return grads, residuals
    names = compressed_leaves(grads, residuals, ccfg, pattern_len)
    f2p_ef_roundtrip([grads[n] for n in names], [residuals[n] for n in names],
                     ccfg.fmt, block=ccfg.block,
                     error_feedback=ccfg.error_feedback)
    return grads, residuals


def init_residuals(params, ccfg: CompressionConfig, pattern_len: int) -> dict:
    """Zero f32 residuals for compressible leaves, ``None`` for small ones
    (never a broadcastable scalar)."""
    from repro_torch.optim.adamw import named_params

    named = named_params(params)
    sizes = reference_numel(named, pattern_len)
    return {n: (torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                if sizes[n] >= ccfg.min_size else None)
            for n, p in named.items()}


def compressed_psum(g: torch.Tensor, group, ccfg: CompressionConfig):
    """Mean-reduce ``g`` over the process group ``group`` (None: the
    world) exchanging QTensor leaves on the gather leg, step for step the
    reference's shard_map path:

    1. reduce-scatter ``g``'s rows (``g.reshape(n, -1)``, zero-padded to a
       multiple of the group's size W) in the input dtype;
    2. quantize the local SUM shard (f32; ``ccfg.packed`` packs the codes);
    3. ``scale_by(1 / W)``: an f32 multiply of the scales, so
       quantize(sum) / W and quantize(sum / W) agree and the gather side
       needs no divide;
    4. all-gather the codes and the scales;
    5. dequantize the reassembled QTensor once, in f32;
    6. slice the pad off and cast back to ``g``'s dtype.

    Wire bytes: N/W x 4 on the scatter leg (f32), N x (n_bits / 8 packed,
    or the code dtype's size, + 4 / block) on the gather leg."""
    import torch.distributed as dist

    from repro_torch.core import qtensor as QT
    from repro_torch.core.qtensor import QTensor
    from repro_torch.launch import mesh as M

    if group is None and not dist.is_initialized():
        raise RuntimeError("compressed_psum reduces over a torch.distributed "
                           "process group: none is initialized")
    w = dist.get_world_size(group)
    n = g.shape[0]
    packed = QT.resolve_packed(ccfg.packed)
    g2 = g.reshape(n, -1)
    pad = (-n) % w
    if pad:
        g2 = torch.nn.functional.pad(g2, (0, 0, 0, pad))
    shard_sum = M.reduce_scatter(g2, group,
                                 leg="compressed_psum.reduce_scatter")
    cols = shard_sum.shape[-1]
    qt = QT.quantize(shard_sum.to(torch.float32), ccfg.fmt,
                     block=ccfg.block, packed=packed).scale_by(1.0 / w)
    codes_all = M.all_gather(qt.codes, group,
                             leg="compressed_psum.all_gather")
    scale_all = M.all_gather(qt.scales, group,
                             leg="compressed_psum.all_gather")
    full = QTensor.from_parts(codes_all, scale_all, ccfg.fmt, ccfg.block,
                              (codes_all.shape[0], cols), packed=packed)
    out = full.dequantize(torch.float32)
    return out[:n].reshape(g.shape).to(g.dtype)
