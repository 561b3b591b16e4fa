"""Multi-pod dry run (port of ``repro.launch.dryrun``).

For every (architecture x input shape) cell, run one rank's real
train / prefill / serve step on fake tensors (``FakeTensorMode``: shapes
and dtypes, no data) in a fake world of the production mesh's size
(``launch.mesh.fake_world``) — (16, 16) single pod and (2, 16, 16) two
pods — under the op analysis (``launch.op_analysis``), and record its
FLOPs, HBM bytes, collectives and memory for the roofline.

Usage:
    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
        --out experiments/dryrun_torch
    python -m repro_torch.launch.dryrun --arch jamba_1_5_large \\
        --shape long_500k

How a cell runs: rank 0 of the fake world, on fake CPU tensors (a fake
CUDA tensor would reach the kernels' loader). The kernels' wrappers are
charged their costs (``kernels.cost``) and return fake results; nothing
runs on a device. ``compile_s`` is the seconds the traced step took.

- train: ``make_train_step`` on the train state sharded by the
  reference's rules (``train_state_specs`` / ``shard_state``), with the
  rank's slice of the data axes: the sharded step computes each split
  layer's part on the model axis (``launch.shardings.split_plan``; its
  leaves stay local), gathers the leaves of the layer kinds that compute
  whole, and all-reduces the gradients over the data axes. The record's
  ``placement`` and ``model_split`` name the kinds that split and those
  that compute whole.
- prefill / decode: the reference's inline ``prefill`` and
  ``decode_step`` + argmax, run as the sharded trainer runs: the rank
  gathers the parameters (sharded by ``params_specs``), computes its
  data-axis slice of the batch and holds those rows' caches over the
  whole sequence; decode writes and reads position ``seq - 1``. A batch
  that does not split over the data ranks (``long_500k``, batch 1) runs
  whole on rank 0. The port serves with no model-axis or context
  parallelism (C27); each record says where it ran (``placement``).

The state is built from an uninitialised ``Model`` (``init_params``'s
truncated normal reads its own draws, which fake tensors cannot).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

from repro_torch.configs import (ARCH_IDS, SHAPES, full_config, input_specs,
                                 shape_is_applicable)
from repro_torch.launch import roofline as RL


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.mesh.shape)


def _data_slice(mesh, gbatch: int, split: str | None = None):
    """(rows this rank computes, placement text); ``split``: the train
    cell's model-axis split (``launch.shardings.split_text``)."""
    from repro_torch.launch.mesh import data_axes, mesh_shape

    sizes = mesh_shape(mesh)
    d = math.prod(sizes[a] for a in data_axes(mesh))
    if gbatch % d == 0:
        model = split or f"the model axis ({sizes['model']}) replicated"
        return gbatch // d, (f"data parallel: {gbatch // d} of {gbatch} "
                                f"rows a rank over {d} data ranks, {model}")
    return gbatch, (f"whole batch ({gbatch} rows) on rank 0: it does not "
                       f"split over {d} data ranks, no context parallelism")


def _fake_input(spec, rows: int):
    import torch

    shape = (rows, *spec.shape[1:])
    if spec.dtype.is_floating_point:
        return torch.empty(shape, dtype=spec.dtype)
    return torch.zeros(shape, dtype=spec.dtype)


def _step_inputs(cfg, shape_name: str, rows: int) -> dict:
    """This rank's rows of every model input of the cell, fake, on the
    CPU."""
    return {k: _fake_input(v, rows)
            for k, v in input_specs(cfg, shape_name).items()}


def _train_cell(cfg, mesh, rules, batch):
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.launch.shardings import train_state_specs
    from repro_torch.optim import AdamWConfig, CompressionConfig
    from repro_torch.train import init_train_state, make_train_step

    ocfg, ccfg = AdamWConfig(), CompressionConfig(enabled=True)
    state = init_train_state(cfg, ocfg, ccfg, seed=None, device="cpu",
                             shardings=train_state_specs(
                                 cfg, ocfg, ccfg, mesh, rules)[0])
    step = make_train_step(cfg, ocfg, ccfg)
    _, counts = analyze(step, state, batch, fake=True)
    return counts


def _serve_params(cfg, mesh, rules):
    """The parameters sharded by ``params_specs``, and a step prologue that
    gathers them (the sharded trainer's parameter all-gather)."""
    from repro_torch.launch.shardings import (gather_full, params_specs,
                                              set_params, shard_state)
    from repro_torch.models.model import Model

    model = Model(cfg, device="cpu")
    shardings, _ = params_specs(cfg, mesh, rules)
    shard_state(model, shardings)

    def gathered():
        full = {n: gather_full(p.data, leg="serve.param_all_gather")
                for n, p in model.named_parameters()}
        return set_params(model, full)

    return model, gathered


def _serve_cell(cfg, mesh, rules, batch, rows, seq, kind, quantized_kv):
    import torch

    from repro_torch.launch.op_analysis import analyze
    from repro_torch.launch.shardings import set_params
    from repro_torch.models.model import decode_step, init_caches, prefill

    model, gathered = _serve_params(cfg, mesh, rules)
    caches = init_caches(cfg, rows, seq, quantized_kv=quantized_kv,
                         device="cpu")

    def step(model, batch, caches):
        old = gathered()
        try:
            if kind == "prefill":
                return prefill(model, batch["tokens"], caches, cfg=cfg,
                               frames=batch.get("frames"),
                               patches=batch.get("patches"))
            logits = decode_step(model, batch["token"], seq - 1, caches,
                                 cfg=cfg)
            return torch.argmax(logits, -1)[:, None].to(torch.int32)
        finally:
            set_params(model, old)

    _, counts = analyze(step, model, batch, caches, fake=True)
    return counts


def device_cell(arch: str, kind: str, rows: int, seq: int, *,
                smoke: bool = False, device="cuda", fake: bool = False):
    """One device's step with no mesh, as ``(step, args)``, on ``arch``'s
    full config (``smoke``: its smoke config) with the fused attention:
    ``kind`` "train" is the train CLI's step
    (``launch.train.train_configs``) on ``rows`` x ``seq`` tokens;
    "decode" is ``decode_step`` + argmax for ``rows`` slots over packed
    caches of ``seq`` positions at position ``seq // 2``. Real tensors on
    ``device`` (parameters from seed 0), or with ``fake`` shapes only (call
    inside a ``FakeTensorMode``): the same step either way, so a count on
    the card and a count on fake CPU tensors can be held to each other."""
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.models.model import (Model, decode_step, init_caches,
                                          init_params)

    cfg = dataclasses.replace(
        (smoke_config if smoke else full_config)(arch), fused_attention=True)
    g = None if fake else torch.Generator(device=device).manual_seed(0)

    def tokens(shape):
        if fake:
            return torch.zeros(shape, dtype=torch.int32, device=device)
        return torch.randint(0, cfg.vocab_size, shape, generator=g,
                             device=device, dtype=torch.int32)

    if kind == "train":
        from repro_torch.launch.train import train_configs
        from repro_torch.train import init_train_state, make_train_step

        ocfg, ccfg, _, _ = train_configs(cfg, arch=arch, steps=8,
                                         global_batch=rows, seq=seq)
        state = init_train_state(cfg, ocfg, ccfg, seed=None if fake else 0,
                                 device=device)
        batch = {"tokens": tokens((rows, seq)), "labels": tokens((rows, seq))}
        return make_train_step(cfg, ocfg, ccfg), (state, batch)
    model = Model(cfg, device=device) if fake else init_params(
        cfg, seed=0, device=device)
    caches = init_caches(cfg, rows, seq, quantized_kv=True, device=device)

    def serve_step(model, token, caches):
        logits = decode_step(model, token, seq // 2, caches, cfg=cfg)
        return torch.argmax(logits, -1)[:, None].to(torch.int32)

    return serve_step, (model, tokens((rows, 1)), caches)


def lower_cell(arch: str, shape_name: str, mesh, *, quantized_kv=False,
               cfg=None, optimized: bool = False):
    """Run one cell's step for rank 0 of ``mesh`` (a DeviceMesh of a fake
    world, ``device="cpu"``) on fake tensors under the op analysis.
    Returns (counts, cfg, meta): the counts take the reference's
    compiled executable's place (``roofline.analyze`` reads them).

    optimized=True turns on the beyond-paper perf knobs (bwd dtype cast,
    head-sharded attention, chunked attention)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.shardings import (params_specs, rules_for,
                                              split_plan, split_text)
    from repro_torch.models.sharding import logical_rules

    cfg = cfg or full_config(arch)
    if optimized:
        cfg = dataclasses.replace(cfg, opt_bwd_cast=True, opt_head_shard=True,
                                  attn_impl="chunked")
    seq, gbatch, kind = SHAPES[shape_name]
    rules = rules_for(cfg, mesh, shape_name)
    n_dev = mesh.size()
    plan = (split_plan(cfg, params_specs(cfg, mesh, rules)[0])
            if kind == "train" else None)
    rows, placement = _data_slice(mesh, gbatch,
                                  plan and split_text(plan))
    with FakeTensorMode(allow_non_fake_inputs=True), \
            logical_rules(rules, mesh):
        batch = _step_inputs(cfg, shape_name, rows)
        if kind == "train":
            counts = _train_cell(cfg, mesh, rules, batch)
        else:
            counts = _serve_cell(cfg, mesh, rules, batch, rows, seq, kind,
                                 quantized_kv)
    meta = dict(arch=arch, shape=shape_name, mesh=_mesh_name(mesh),
                kind=kind, seq=seq, global_batch=gbatch, n_devices=n_dev,
                quantized_kv=quantized_kv, placement=placement)
    if plan is not None:
        meta["model_split"] = plan["kinds"]
    return counts, cfg, meta


def run_cell(arch: str, shape_name: str, mesh, out_dir: str | None, **kw):
    t0 = time.time()
    seq, gbatch, kind = SHAPES[shape_name]
    cfg = full_config(arch)
    ok, why = shape_is_applicable(cfg, shape_name)
    mesh_name = _mesh_name(mesh)
    tag = f"{arch}__{shape_name}__{mesh_name}"
    if not ok:
        rec = dict(arch=arch, shape=shape_name, mesh=mesh_name,
                   status="skipped", reason=why)
        _write(out_dir, tag, rec)
        print(f"SKIP  {tag}: {why}", flush=True)
        return rec
    try:
        counts, cfg, meta = lower_cell(arch, shape_name, mesh, cfg=cfg, **kw)
        rl = RL.analyze(counts, arch=arch, shape=shape_name,
                        mesh_name=mesh_name, n_devices=mesh.size(),
                        cfg=cfg, seq=seq, gbatch=gbatch, kind=kind)
        rec = {**meta, **rl.to_dict(), "kernels": counts["kernels"],
               "status": "ok", "compile_s": round(time.time() - t0, 1)}
        _write(out_dir, tag, rec)
        print(f"OK    {tag}: {rec['compile_s']}s "
              f"bottleneck={rl.bottleneck} "
              f"t=({rl.t_compute:.3e},{rl.t_memory:.3e},{rl.t_collective:.3e})s "
              f"useful={rl.useful_flops_ratio:.2f}", flush=True)
        return rec
    except Exception as e:
        rec = dict(arch=arch, shape=shape_name, mesh=mesh_name,
                   status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        _write(out_dir, tag, rec)
        print(f"FAIL  {tag}: {type(e).__name__}: {str(e)[:200]}", flush=True)
        return rec


def _write(out_dir, tag, rec):
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)


def main(argv=None):
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--quantized-kv", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    pods = []
    if args.mesh in ("single", "both"):
        pods.append(False)
    if args.mesh in ("multi", "both"):
        pods.append(True)

    n_ok = n_fail = n_skip = 0
    for multi_pod in pods:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            mesh_name = _mesh_name(mesh)
            for arch in archs:
                for shape in shapes:
                    tag = f"{arch}__{shape}__{mesh_name}"
                    path = os.path.join(args.out, tag + ".json")
                    if args.skip_existing and os.path.exists(path):
                        with open(path) as f:
                            prev = json.load(f)
                        if prev.get("status") in ("ok", "skipped"):
                            print(f"CACHED {tag} ({prev['status']})",
                                  flush=True)
                            n_ok += prev["status"] == "ok"
                            n_skip += prev["status"] == "skipped"
                            continue
                    rec = run_cell(arch, shape, mesh, args.out,
                                   quantized_kv=args.quantized_kv)
                    n_ok += rec["status"] == "ok"
                    n_fail += rec["status"] == "error"
                    n_skip += rec["status"] == "skipped"
    print(f"\nDRYRUN SUMMARY: ok={n_ok} skipped={n_skip} failed={n_fail}",
          flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
