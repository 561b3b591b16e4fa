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
holds the shards the rules give it; compute is data parallel over the
mesh's data axes: every rank gathers the full parameters, runs forward
and backward on its data slice of the batch, and the gradients are summed
over the data axes in f32 and scaled by 1/d. Each rank then keeps its
slice of every gradient, and the round trip, the norm and AdamW run on
the local shards (:func:`ef_local_split` says which leaves the round trip
can take shard by shard; the others run on the whole leaf).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.f2p_quant import f2p_ef_roundtrip
from repro_torch.models import init_params, train_forward
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.optim.compress import (CompressionConfig, compress_decompress,
                                        compressed_leaves, init_residuals)


def init_train_state(cfg: ModelConfig, ocfg: adamw.AdamWConfig,
                     ccfg: CompressionConfig, seed: int = 0, device="cuda"):
    """Fresh state: random parameters from ``torch.Generator`` ``seed``
    (gradients on), zero moments, zero residuals."""
    del ocfg   # the reference's signature; AdamW's state needs no config
    model = init_params(cfg, seed=seed, device=device)
    model.requires_grad_(True)
    return {"params": model, "opt": adamw.init_state(model),
            "residuals": init_residuals(model, ccfg, len(cfg.pattern))}


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


def sharded_train_step(state, batch, cfg: ModelConfig,
                       ocfg: adamw.AdamWConfig, ccfg: CompressionConfig):
    """One step on a state of DTensors; ``batch`` is this rank's slice of
    the data axes. Returns (state, metrics), the metrics averaged over the
    data axes."""
    from repro_torch.launch.shardings import (gather_full, is_owner,
                                              local_slice, set_params)

    model = state["params"]
    named = dict(model.named_parameters())
    mesh = model.embed.device_mesh
    full = {n: gather_full(p.data, leg="train.param_all_gather").detach()
            .requires_grad_(p.requires_grad) for n, p in named.items()}
    old = set_params(model, full)
    try:
        loss, metrics, grads = loss_and_grads(model, batch, cfg)
    finally:
        set_params(model, old)
    del full
    _reduce_grads(grads, mesh)
    with torch.no_grad():
        local = {n: local_slice(grads[n], named[n]).contiguous()
                 for n in named}
        res = state["residuals"]
        if ccfg.enabled:
            names = compressed_leaves(grads, res, ccfg, len(cfg.pattern))
            aligned, gathered = ef_local_split(res, names, ccfg.block)
            if aligned:
                f2p_ef_roundtrip([local[n] for n in aligned],
                                 [res[n].to_local() for n in aligned],
                                 ccfg.fmt, block=ccfg.block,
                                 error_feedback=ccfg.error_feedback)
            if gathered:
                rfull = [gather_full(res[n], leg="train.residual_all_gather")
                         for n in gathered]
                f2p_ef_roundtrip([grads[n] for n in gathered], rfull,
                                 ccfg.fmt, block=ccfg.block,
                                 error_feedback=ccfg.error_feedback)
                for n, r in zip(gathered, rfull):
                    res[n].to_local().copy_(local_slice(r, res[n]))
                    local[n] = local_slice(grads[n], named[n]).contiguous()
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
