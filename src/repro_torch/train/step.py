"""Train-step factory (port of ``repro.train.step``): loss + gradients +
F2P gradient compression + AdamW.

The train state is a plain dict, as in the reference:
``{"params": Model, "opt": {"mu", "nu", "step"}, "residuals"}``, moments
and residuals keyed by parameter name. The step runs eagerly (no
``torch.compile``) and updates the state IN PLACE: autograd writes each
parameter's ``.grad``, compression rewrites the gradients and residuals
where they lie (one launch of B5's round-trip mode for all compressed
leaves on the card) and AdamW updates parameters and moments leaf by
leaf. The compressed gradients stay in ``.grad`` until the next step
clears them.

A state placed on a DeviceMesh (``launch.shardings.shard_state``: its
parameters, moments and residuals are DTensors) takes
:func:`sharded_train_step`, picked by the parameters' type. Each rank
holds the shards the rules give it and computes its data slice of the
batch. Over the model axis it computes the part of every layer that the
rules gave that axis (``launch.shardings.split_plan``, read from the
parameters' placements: its vocabulary rows, heads, FF width, experts and
recurrent channels): such a layer's leaves stay local over the model axis
(gathered over the data axes only where ``cfg.fsdp`` splits them there),
and the layer joins its partial results with the model-axis collectives
of ``models.parallel``. A layer kind
that does not split gathers its leaves whole and computes whole, as every
layer of a mesh with one model rank does. The gradients come out in the
parameters' local extents; they are summed over the data axes in f32 and
scaled by 1/d, each rank keeps its slice, and the round trip, the norm
and AdamW run on the local shards (:func:`ef_local_split` says which
leaves the round trip can take shard by shard; the others run on the
whole leaf).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.f2p_quant import f2p_ef_roundtrip
from repro_torch.models import Model, init_params, train_forward
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.optim.compress import (CompressionConfig, compress_decompress,
                                        compressed_leaves, init_residuals)


def init_train_state(cfg: ModelConfig, ocfg: adamw.AdamWConfig,
                     ccfg: CompressionConfig, seed: int | None = 0,
                     device="cuda", shardings: dict | None = None):
    """Fresh state: random parameters from ``torch.Generator`` ``seed``
    (gradients on), zero moments, zero residuals; ``seed=None`` leaves the
    parameters uninitialised (shapes, for the dry run's fake tensors).

    With ``shardings`` (``launch.shardings.train_state_specs``) the state is
    placed on their mesh without the whole state ever on the device: the
    parameters are drawn whole (the one-process run's draws) and each rank
    keeps its slices; the moments and residuals are made as this rank's
    zeros."""
    model = (Model(cfg, device) if seed is None
             else init_params(cfg, seed=seed, device=device))
    model.requires_grad_(True)
    if shardings is None:
        return {"params": model, "opt": adamw.init_state(model),
                "residuals": init_residuals(model, ccfg, len(cfg.pattern))}
    from repro_torch.launch.shardings import abstract_train_state, shard_state

    state = dict(abstract_train_state(cfg, ocfg, ccfg), params=model)
    state["opt"]["step"] = torch.zeros((), dtype=torch.int32, device=device)
    shard_state(state, shardings)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()   # the whole draws go back to the card
    return state


def loss_and_grads(model, batch, cfg: ModelConfig):
    """Forward + backward: (loss, metrics, name -> gradient). Earlier
    gradients are dropped first, so ``.grad`` holds this batch's only. A
    parameter the batch does not reach (``vision_proj`` of a text-only
    batch) gets a zero gradient, as under ``jax.grad``, so AdamW's weight
    decay still moves it as the reference's does."""
    for p in model.parameters():
        p.grad = None
    loss, metrics = train_forward(model, batch, cfg)
    loss.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = {n: p.grad for n, p in model.named_parameters()}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------
def ef_local_split(residuals: dict, names: list, block: int):
    """(aligned, gathered): the compressed leaves whose round trip runs on
    the local shard, and those it must run on the whole leaf. B5's blocks
    run along the last axis of the whole leaf, so a shard gives the
    unsharded result only where that axis is not split or its local width
    is a multiple of ``block`` (shard borders then fall on block
    borders)."""
    from torch.distributed.tensor import DTensor, Shard

    aligned, gathered = [], []
    for n in names:
        r = residuals[n]
        last = r.ndim - 1
        split = isinstance(r, DTensor) and any(
            isinstance(p, Shard) and p.dim == last
            and r.device_mesh.size(i) > 1 for i, p in enumerate(r.placements))
        ok = not split or r.to_local().shape[-1] % block == 0
        (aligned if ok else gathered).append(n)
    return aligned, gathered


def ef_border_split(residuals: dict, gathered: list, block: int):
    """(bordered, whole): of ``ef_local_split``'s gathered leaves, those
    whose last axis is split over the model axis alone at a local width
    of at least ``block`` (:func:`roundtrip_across_borders` takes them:
    each block then straddles at most one border), and the rest (the
    round trip on the whole leaf, C26)."""
    from torch.distributed.tensor import Shard

    bordered, whole = [], []
    for n in gathered:
        r = residuals[n]
        mesh, last = r.device_mesh, r.ndim - 1
        on = [mesh.mesh_dim_names[i] for i, p in enumerate(r.placements)
              if isinstance(p, Shard) and p.dim == last and mesh.size(i) > 1]
        ok = on == ["model"] and r.to_local().shape[-1] >= block
        (bordered if ok else whole).append(n)
    return bordered, whole


def roundtrip_across_borders(gs: list, rs: list, group, rank: int,
                             world: int, block: int) -> tuple:
    """Extend each local shard ``g`` / ``r`` ([..., w], w >= ``block``;
    the leaf's last axis split evenly over the ``world`` ranks of
    ``group``, this rank's columns from ``rank * w``) by its neighbours'
    columns of the blocks that straddle its borders, so that its first
    column starts a block of the whole leaf: one all-gather of every
    rank's first and last ``block`` columns a tensor. Returns the
    extended copies and each one's offset of this rank's columns; B5's
    round trip on them gives the whole leaf's bits for every block, and
    the caller copies columns [offset, offset + w) back."""
    from repro_torch.launch import mesh as M

    exts, offsets = [], []
    for g, r in zip(gs, rs):
        w = g.shape[-1]
        left = (rank * w) % block
        right = (-(rank + 1) * w) % block if rank < world - 1 else 0
        offsets.append(left)
        for t in (g, r):
            edges = torch.cat([t[..., :block], t[..., w - block:]], dim=-1)
            got = M.all_gather(edges.reshape(1, -1), group,
                               "train.roundtrip_edge_gather").reshape(
                                   world, *edges.shape)
            parts = [got[rank - 1][..., 2 * block - left:]] if left else []
            parts.append(t)
            if right:
                parts.append(got[rank + 1][..., :right])
            exts.append(torch.cat(parts, dim=-1))
    return exts[0::2], exts[1::2], offsets


def _data_dims(mesh) -> list[int]:
    """Mesh dims of the data axes that hold more than one rank."""
    from repro_torch.launch.mesh import data_axes

    names = mesh.mesh_dim_names
    return [names.index(a) for a in data_axes(mesh)
            if a in names and mesh.size(names.index(a)) > 1]


def _mean_over_data(flat: torch.Tensor, mesh, leg: str) -> torch.Tensor:
    """Sum ``flat`` (f32) over the mesh's data axes and scale by 1 / d, in
    place."""
    from repro_torch.launch import mesh as M

    d = 1
    for i in _data_dims(mesh):
        M.all_reduce(flat, mesh.get_group(i), leg=leg)
        d *= mesh.size(i)
    return flat.mul_(1.0 / d) if d > 1 else flat


@torch.no_grad()
def _reduce_grads(grads: dict, mesh) -> None:
    """The data-parallel gradient: every full gradient summed over the data
    axes in f32 (one all-reduce of all leaves per data axis) and scaled by
    1 / d, in place."""
    if not _data_dims(mesh):
        return
    flat = torch.cat([g.reshape(-1).to(torch.float32)
                      for g in grads.values()])
    _mean_over_data(flat, mesh, "train.grad_all_reduce")
    off = 0
    for g in grads.values():
        g.copy_(flat[off:off + g.numel()].reshape(g.shape))
        off += g.numel()


def _sharded_norm(grads: dict, owners: dict) -> torch.Tensor:
    """Norm of the whole gradient from local shards: each distinct shard
    counts once, on the rank that owns it, in a sum over the world."""
    from repro_torch.launch import mesh as M

    total = None
    for n, g in grads.items():
        s = g.to(torch.float32).square().sum()
        if not owners[n]:
            s = torch.zeros_like(s)
        total = s if total is None else total + s
    M.all_reduce(total, None, leg="train.norm_all_reduce")
    return torch.sqrt(total)


def _whole(t: torch.Tensor, like, dims, leg: str) -> torch.Tensor:
    """The full tensor of ``t``, this rank's part of a DTensor laid out as
    ``like`` that is whole over every mesh axis but ``dims``."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.shardings import gather_full

    mesh = like.device_mesh
    pl = [p if a in dims else Replicate()
          for a, p in zip(mesh.mesh_dim_names, like.placements)]
    return gather_full(DTensor.from_local(t, mesh, pl, run_check=False),
                       leg=leg)


def sharded_train_step(state, batch, cfg: ModelConfig,
                       ocfg: adamw.AdamWConfig, ccfg: CompressionConfig):
    """One step on a state of DTensors; ``batch`` is this rank's slice of
    the data axes. Returns (state, metrics), the metrics averaged over the
    data axes."""
    from repro_torch.launch.shardings import (gather_full, is_owner,
                                              local_slice, set_params,
                                              split_plan)
    from repro_torch.models.parallel import model_axis

    model = state["params"]
    named = dict(model.named_parameters())
    mesh = model.embed.device_mesh
    local_names = set(split_plan(cfg, named)["local"])
    data = [a for a in mesh.mesh_dim_names if a != "model"]
    full = {}
    for n, p in named.items():
        t = (gather_full(p.data, leg="train.param_data_gather", dims=data)
             if n in local_names else
             gather_full(p.data, leg="train.param_all_gather"))
        full[n] = t.detach().requires_grad_(p.requires_grad)
    old = set_params(model, full)
    try:
        ctx = (model_axis(mesh) if "model" in mesh.mesh_dim_names
               else contextlib.nullcontext())
        with ctx:
            loss, metrics, grads = loss_and_grads(model, batch, cfg)
    finally:
        set_params(model, old)
    del full
    _reduce_grads(grads, mesh)

    def mine(n, g):
        return local_slice(g, named[n], data if n in local_names else None
                           ).contiguous()

    with torch.no_grad():
        local = {n: mine(n, grads[n]) for n in named}
        res = state["residuals"]
        if ccfg.enabled:
            names = compressed_leaves(named, res, ccfg, len(cfg.pattern))
            aligned, gathered = ef_local_split(res, names, ccfg.block)
            bordered, gathered = ef_border_split(res, gathered, ccfg.block)
            gs = [local[n] for n in aligned]
            rs = [res[n].to_local() for n in aligned]
            if bordered:
                eg, er, offs = roundtrip_across_borders(
                    [local[n] for n in bordered],
                    [res[n].to_local() for n in bordered],
                    mesh.get_group("model"), mesh.get_local_rank("model"),
                    mesh.size(mesh.mesh_dim_names.index("model")),
                    ccfg.block)
                gs, rs = gs + eg, rs + er
            if gs:   # one launch for the local shards and the extended
                f2p_ef_roundtrip(gs, rs, ccfg.fmt, block=ccfg.block,
                                 error_feedback=ccfg.error_feedback)
            if bordered:
                for n, g, r, o in zip(bordered, eg, er, offs):
                    w = local[n].shape[-1]
                    local[n].copy_(g[..., o:o + w])
                    res[n].to_local().copy_(r[..., o:o + w])
                del eg, er, gs, rs, g, r
            if gathered:
                # B5's blocks straddle this rank's border: the round trip
                # runs on the whole leaf (C26)
                gfull = [_whole(grads[n], named[n], ["model"],
                                "train.grad_model_gather")
                         if n in local_names else grads[n] for n in gathered]
                rfull = [gather_full(res[n], leg="train.residual_all_gather")
                         for n in gathered]
                f2p_ef_roundtrip(gfull, rfull, ccfg.fmt, block=ccfg.block,
                                 error_feedback=ccfg.error_feedback)
                for n, g, r in zip(gathered, gfull, rfull):
                    res[n].to_local().copy_(local_slice(r, res[n]))
                    local[n] = local_slice(g, named[n]).contiguous()
                del gfull, rfull, g, r
        del grads
        gnorm = _sharded_norm(local, {n: is_owner(p)
                                      for n, p in named.items()})
        opt = state["opt"]
        lstate = {"mu": {n: t.to_local() for n, t in opt["mu"].items()},
                  "nu": {n: t.to_local() for n, t in opt["nu"].items()},
                  "step": opt["step"]}
        _, _, om = adamw.apply_updates(
            {n: p.data.to_local() for n, p in named.items()}, local, lstate,
            ocfg, gnorm=gnorm)
        opt["step"] = lstate["step"]
        out = dict(metrics, loss=loss)
        if _data_dims(mesh):
            vec = torch.stack([v.to(torch.float32) for v in out.values()])
            out = dict(zip(out, _mean_over_data(
                vec, mesh, "train.metric_all_reduce")))
    return state, dict(out, **om)


def make_train_step(cfg: ModelConfig, ocfg: adamw.AdamWConfig,
                    ccfg: CompressionConfig):
    def train_step(state, batch):
        from torch.distributed.tensor import DTensor

        model = state["params"]
        if isinstance(model.embed, DTensor):
            return sharded_train_step(state, batch, cfg, ocfg, ccfg)
        loss, metrics, grads = loss_and_grads(model, batch, cfg)
        compress_decompress(grads, state["residuals"], ccfg,
                            len(cfg.pattern))
        _, _, om = adamw.apply_updates(model, grads, state["opt"], ocfg)
        return state, dict(metrics, loss=loss, **om)

    return train_step
