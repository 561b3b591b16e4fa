"""Spawned gloo worlds for the port's sharded tests, and the work their
ranks do.

:func:`spawn` starts ``world`` processes (``spawn`` start method), each
pinned to one torch thread and joined into a gloo process group on a free
localhost port, runs ``fn(rank, world, *args)`` in each and returns the
ranks' results in rank order. The work functions live here, not in the
test files, so a rank imports torch and the port only (never JAX).
"""
from __future__ import annotations

import os
import pickle
import socket
import tempfile

import numpy as np
import torch

CPU = "cpu"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, args, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        res = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def spawn(fn, world: int, *args) -> list:
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; their results."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_entry, args=(world, _free_port(), fn, args, d),
                           nprocs=world, start_method="spawn")
        out = []
        for r in range(world):
            with open(os.path.join(d, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def full_state(state) -> dict:
    """Every parameter, moment and residual of a (sharded) train state as
    whole numpy arrays (gathering DTensors: a collective)."""
    from repro_torch.launch.shardings import gather_full

    out = {"params": {n: _np(gather_full(p.data)) for n, p in
                      state["params"].named_parameters()}}
    for k in ("mu", "nu"):
        out[k] = {n: _np(gather_full(t)) for n, t in state["opt"][k].items()}
    out["residuals"] = {n: _np(gather_full(t)) for n, t in
                        state["residuals"].items() if t is not None}
    out["step"] = int(state["opt"]["step"])
    return out


# ---------------------------------------------------------------------------
# Work
# ---------------------------------------------------------------------------
def train_jobs(rank, world, jobs):
    """Each job ``(tag, arch, mesh_shape, fsdp, ckpt_dir, steps[,
    config overrides])`` trains a smoke config on the mesh through
    ``launch.train.run``; rank 0 returns
    ``{tag: (losses, gnorms, full_state, ef_split, state_bytes, legs,
    split_plan)}`` (``legs``: rank 0's named collectives a step)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.launch.train import run, train_configs
    from repro_torch.optim.compress import compressed_leaves
    from repro_torch.train.step import ef_local_split

    out = {}
    for tag, arch, shape, fsdp, ckpt_dir, steps, *over in jobs:
        cfg = dataclasses.replace(smoke_config(arch), fsdp=fsdp,
                                  **(over[0] if over else {}))
        state, info = run(cfg, arch=arch, steps=steps, global_batch=4,
                          seq=16, ckpt_dir=ckpt_dir, ckpt_every=100,
                          device=CPU, log=lambda *_: None, mesh_shape=shape)
        _, ccfg, _, _ = train_configs(cfg, arch=arch, steps=steps)
        res = state["residuals"]
        names = compressed_leaves(
            {n: p for n, p in state["params"].named_parameters()}, res,
            ccfg, len(cfg.pattern))
        split = ef_local_split(res, names, ccfg.block)
        full = full_state(state)
        out[tag] = ([h["loss"] for h in info["history"]],
                    [h["grad_norm"] for h in info["history"]], full, split,
                    info["state_bytes"], info["legs"], info["split"])
    return out if rank == 0 else None


def restore_onto(rank, world, arch, shape, ckpt_dir):
    """A fresh state on a ``shape`` mesh, restored from ``ckpt_dir``'s
    latest step (written on another mesh); rank 0 returns it whole."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.launch.shardings import rules_for, train_state_specs
    from repro_torch.launch.train import train_configs
    from repro_torch.train import checkpoint, init_train_state

    cfg = smoke_config(arch)
    ocfg, ccfg, _, _ = train_configs(cfg, arch=arch, steps=3)
    mesh = compat_make_mesh(shape, ("data", "model"), CPU)
    shardings, _ = train_state_specs(cfg, ocfg, ccfg, mesh,
                                     rules_for(cfg, mesh, "train_4k"))
    state = init_train_state(cfg, ocfg, ccfg, seed=5, device=CPU)
    state, step = checkpoint.restore(ckpt_dir, state, shardings=shardings)
    full = full_state(state)
    return (step, full) if rank == 0 else None


def constrain_check(rank, world):
    """``constrain`` on a DTensor under (2, 2) rules redistributes to the
    rules' placements and keeps the values; on a plain tensor it passes."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models.sharding import (constrain, logical_rules,
                                             make_rules)

    mesh = compat_make_mesh((2, 2), ("data", "model"), CPU)
    x = torch.arange(4 * 3 * 8 * 2, dtype=torch.float32).reshape(4, 3, 8, 2)
    d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    plain = torch.ones(3)
    with logical_rules(make_rules(fsdp=False), mesh):
        y = constrain(d, ("batch", None, "heads", None))
        z = constrain(y, ("batch", "seq", None))      # trailing dims None
        same = constrain(plain, ("batch",)) is plain
    outside = constrain(d, ("batch", None, "heads", None)) is d
    return dict(y=tuple(y.placements) == (Shard(0), Shard(2)),
                z=tuple(z.placements) == (Shard(0), Replicate()),
                values=bool(torch.equal(y.full_tensor(), x)
                            and torch.equal(z.full_tensor(), x)),
                local=tuple(y.to_local().shape), same=same, outside=outside)


def psum_jobs(rank, world, cases):
    """``compressed_psum`` of each case's row ``rank`` (its ``[W, ...]``
    array), unpacked and packed; returns ``{(tag, packed): numpy}``."""
    from repro_torch.core.f2p import F2PFormat, Flavor
    from repro_torch.launch import mesh as M
    from repro_torch.optim.compress import CompressionConfig, compressed_psum

    out = {}
    for tag, arr, dtype, fmt_args, block in cases:
        fmt = F2PFormat(**dict(fmt_args, flavor=Flavor(fmt_args["flavor"])))
        g = torch.from_numpy(np.ascontiguousarray(arr[rank])).to(
            getattr(torch, dtype))
        for packed in (False, True):
            ccfg = CompressionConfig(fmt=fmt, block=block, packed=packed)
            out[(tag, packed)] = _np(compressed_psum(g, None, ccfg))
    out["host_staged"] = sorted(M.HOST_STAGED)
    return out


def sketch_run(rank, world, cfg_kw, batches, conservative_batches):
    """A row-sharded sketch fed ``batches`` (numpy keys, then the same as
    tensors) and flushed; returns what every rank reads back, and the
    conservative sketch's estimates."""
    from repro_torch.launch.mesh import make_sketch_mesh
    from repro_torch.sketch import F2PSketch, SketchConfig

    mesh = make_sketch_mesh(world, device=CPU)
    sk = F2PSketch(SketchConfig(**cfg_kw), device=CPU, mesh=mesh)
    for i, keys in enumerate(batches):
        if i % 2:
            sk.update(torch.from_numpy(keys))
        else:
            sk.update(keys)
    pending = sk.pending_budget
    probe = np.arange(64)
    before = (sk.query(probe), sk.fill())
    sk.flush()
    cons = F2PSketch(SketchConfig(**dict(cfg_kw, conservative=True)),
                     device=CPU, mesh=mesh)
    for keys in conservative_batches:
        cons.update(keys)
    return dict(rows=tuple(sk.state.shape), pending=pending, before=before,
                state=sk._gather_rows(sk.state).numpy(),
                estimates=sk.estimates(), query=sk.query(probe),
                fill=sk.fill(), arrivals=sk.arrivals,
                pending_after=sk.pending_budget,
                conservative=cons.estimates())


def _split_model(cfg, weights: dict, mesh):
    """A ``Model`` of ``cfg`` on the CPU holding, from the full numpy
    ``weights``, this rank's local slice of every leaf the split plan
    keeps local and the whole of every other leaf (what the sharded step
    hands the forward). Returns (model, plan)."""
    from repro_torch.launch.shardings import (local_slice, rules_for,
                                              set_params, split_plan,
                                              train_state_specs)
    from repro_torch.models.model import Model
    from repro_torch.optim import CompressionConfig

    sh = train_state_specs(cfg, None, CompressionConfig(), mesh,
                           rules_for(cfg, mesh, "train_4k"))[0]["params"]
    plan = split_plan(cfg, sh)
    model = Model(cfg, device=CPU)
    set_params(model, {
        n: torch.from_numpy(w).clone() if n not in plan["local"] else
        local_slice(torch.from_numpy(w), sh[n]).clone()
        for n, w in weights.items()})
    return model, plan


def tp_layers(rank, world, cases):
    """Each case ``(tag, arch, config overrides, weights, layer, inputs,
    cotangent)`` runs one split layer of the smoke config ``arch`` on a (1,
    world) mesh, its leaves this rank's local slices of the full numpy
    ``weights``; rank 0 returns ``{tag: dict(out, grads of the inputs,
    legs, kinds, local)}`` (``out`` and the input gradients are whole on
    every rank). ``layer``: ("vocab", -) embedding + logits + loss;
    ("mixer" | "ff" | "cross", layer index); ("model", -) the whole
    ``train_forward``, whose ``grads`` are the norm weights' (whole on
    every rank)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import attention as A
    from repro_torch.models import parallel as TP
    from repro_torch.models.common import swiglu
    from repro_torch.models.model import _embed, lm_loss, train_forward

    mesh = compat_make_mesh((1, world), ("data", "model"), CPU)
    out = {}
    for tag, arch, over, weights, (where, i), inputs, ct in cases:
        cfg = dataclasses.replace(smoke_config(arch), **over)
        model, plan = _split_model(cfg, weights, mesh)
        xs = {k: torch.from_numpy(v).requires_grad_(v.dtype.kind == "f")
              for k, v in inputs.items()}
        M.reset_legs()
        res = {}
        with TP.model_axis(mesh):
            if where == "model":
                model.requires_grad_(True)
                loss, _ = train_forward(model, xs, cfg)
                loss.backward()
                res.update(loss=float(loss), out=_np(loss), grads={
                    n: _np(p.grad) for n, p in model.named_parameters()
                    if "norm" in n})
                res.update(legs=sorted(M.LEGS), kinds=plan["kinds"],
                           local=sorted(plan["local"]))
                out[tag] = res
                continue
            if where == "vocab":
                e = _embed(model, xs["tokens"], cfg)
                loss = lm_loss(model, xs["x"], xs["labels"], cfg)
                y = loss + (e * torch.from_numpy(ct)).sum()
                res["out"] = _np(e)
                res["loss"] = float(loss)
            else:
                blk = model.blocks[i]
                if where == "mixer":
                    y = blk.mixer.apply(xs["x"], cfg, mode="train")
                elif where == "cross":
                    y = A.attention_apply(blk.cross.weights(), xs["x"], cfg,
                                          mode="train",
                                          cross_kv=xs["cross_kv"])[0]
                elif blk.spec.ff == "moe":
                    y, aux = blk.ff(xs["x"], cfg)
                    res.update(load=_np(aux["load"]),
                               aux_loss=float(aux["aux_loss"]))
                else:
                    ff = blk.ff
                    y = swiglu(xs["x"], ff.gate, ff.up, ff.down,
                               split=ff.down.shape[0] != cfg.d_ff)
                res["out"] = _np(y)
                y = (y * torch.from_numpy(ct)).sum()
            y.backward()
        res["grads"] = {k: _np(t.grad) for k, t in xs.items()
                        if t.grad is not None}
        res.update(legs=sorted(M.LEGS), kinds=plan["kinds"],
                   local=sorted(plan["local"]))
        out[tag] = res
    return out if rank == 0 else None


def tp_loss(rank, world, logits, labels, z_loss):
    """The vocabulary-split cross-entropy of this rank's columns of the
    numpy ``logits`` [B, S, V] on a (1, world) mesh: rank 0 returns the
    loss and the gradient of the whole logits (the ranks' columns
    gathered)."""
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import parallel as TP
    from repro_torch.models.common import softmax_cross_entropy

    mesh = compat_make_mesh((1, world), ("data", "model"), CPU)
    vl = logits.shape[-1] // world
    mine = torch.from_numpy(np.ascontiguousarray(
        logits[..., rank * vl:(rank + 1) * vl])).requires_grad_(True)
    with TP.model_axis(mesh):
        loss = softmax_cross_entropy(mine, torch.from_numpy(labels),
                                     z_loss=z_loss, vocab_start=rank * vl)
        loss.backward()
        grad = TP.gather_model_replicated(mine.grad, -1, "test")
    return (float(loss), _np(grad)) if rank == 0 else None


def tp_sums(rank, world, cases):
    """``models.parallel.from_model`` of row ``rank`` of each case's numpy
    ``[world, ...]`` array in ``dtype`` on a (1, world) mesh: rank 0
    returns ``{tag: (the sum as f32 numpy, its dtype, the legs)}``."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import parallel as TP

    mesh = compat_make_mesh((1, world), ("data", "model"), CPU)
    out = {}
    for tag, arr, dtype in cases:
        M.reset_legs()
        t = torch.from_numpy(arr[rank]).to(getattr(torch, dtype))
        with TP.model_axis(mesh):
            got = TP.from_model(t, "test.sum")
        out[tag] = (_np(got), str(got.dtype), sorted(M.LEGS))
    return out if rank == 0 else None


def tp_roundtrip(rank, world, cases):
    """``train.step.roundtrip_across_borders`` and B5's plain round trip
    on this rank's columns of each case's full numpy ``(g, r)`` (split
    evenly along the last axis), copied back as the sharded step does;
    rank 0 returns ``{tag: (g, r)}``, every rank's columns gathered."""
    from repro_torch.kernels.f2p_quant import f2p_ef_roundtrip
    from repro_torch.launch import mesh as M
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.optim.compress import CompressionConfig
    from repro_torch.train.step import roundtrip_across_borders

    mesh = compat_make_mesh((1, world), ("data", "model"), CPU)
    ccfg = CompressionConfig()
    out = {}
    for tag, g_full, r_full, dtype in cases:
        w = g_full.shape[-1] // world
        g = torch.from_numpy(np.ascontiguousarray(
            g_full[..., rank * w:(rank + 1) * w])).to(getattr(torch, dtype))
        r = torch.from_numpy(np.ascontiguousarray(
            r_full[..., rank * w:(rank + 1) * w]))
        eg, er, offs = roundtrip_across_borders(
            [g], [r], mesh.get_group("model"), rank, world, ccfg.block)
        f2p_ef_roundtrip(eg, er, ccfg.fmt, block=ccfg.block)
        g.copy_(eg[0][..., offs[0]:offs[0] + w])
        r.copy_(er[0][..., offs[0]:offs[0] + w])
        out[tag] = tuple(
            _np(M.all_gather(t.movedim(-1, 0).contiguous(),
                             mesh.get_group("model")).movedim(0, -1))
            for t in (g, r))
    return out if rank == 0 else None


def multi(rank, world, calls):
    """Run ``calls`` (``(name of a work function here, args)``) in order on
    one spawn of the world; their results in order."""
    return [globals()[name](rank, world, *args) for name, args in calls]
