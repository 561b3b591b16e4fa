"""Perf hillclimb (port of ``repro.launch.hillclimb``).

Runs one (arch, shape) cell's dry run (``launch.dryrun.lower_cell``, one
rank of the single-pod fake world) under a named combination of perf
knobs and records the roofline terms, so each hypothesis -> change ->
measure iteration is one invocation:

    python -m repro_torch.launch.hillclimb --arch llama3_2_3b \\
        --shape train_4k --variant bwd_cast,head_shard --out experiments/perf
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.configs import SHAPES, full_config
from repro_torch.launch import roofline as RL
from repro_torch.launch.dryrun import _mesh_name, lower_cell

KNOBS = {
    "bwd_cast": dict(opt_bwd_cast=True),
    "head_shard": dict(opt_head_shard=True),
    "chunked": dict(attn_impl="chunked"),
    "chunk512": dict(attn_chunk=512),
    "chunk1k": dict(attn_chunk=1024),
    "chunk4k": dict(attn_chunk=4096),
    "no_remat": dict(remat=False),
    "fsdp": dict(fsdp=True),
    "no_fsdp": dict(fsdp=False),
    # code-level changes (no cfg override; the label records the code state)
    "ff_shard": {},
    "compress_fix": {},
    "moe_shard": {},
    "seq_par": dict(opt_seq_par=True),
    "sp_local_ff": {},
    "moe_wgather": {},
    "stopgrad_load": {},
    "dense_wgather": {},
}


def run(arch, shape, variant: str, out_dir: str, quantized_kv=False):
    """One variant of one cell on the single-pod production mesh, rank 0
    of a fake world of 256 ranks; writes and returns its record."""
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    cfg = full_config(arch)
    over = {}
    names = [v for v in variant.split(",") if v and v != "baseline"]
    for v in names:
        over.update(KNOBS[v])
    cfg = dataclasses.replace(cfg, **over)
    seq, gbatch, kind = SHAPES[shape]
    t0 = time.time()
    with fake_world(256):
        mesh = make_production_mesh(device="cpu")
        counts, cfg, meta = lower_cell(arch, shape, mesh, cfg=cfg,
                                       quantized_kv=quantized_kv)
    rl = RL.analyze(counts, arch=arch, shape=shape,
                    mesh_name=_mesh_name(mesh), n_devices=mesh.size(),
                    cfg=cfg, seq=seq, gbatch=gbatch, kind=kind)
    rec = {**rl.to_dict(), "variant": variant or "baseline",
           "quantized_kv": quantized_kv,
           "compile_s": round(time.time() - t0, 1)}
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape}__{rec['variant'].replace(',', '+')}" + \
        ("__qkv" if quantized_kv else "")
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    print(f"{tag}: bottleneck={rl.bottleneck} "
          f"t_compute={rl.t_compute:.3f}s t_memory={rl.t_memory:.3f}s "
          f"t_collective={rl.t_collective:.3f}s "
          f"roofline_frac={rl.roofline_fraction:.4f} "
          f"(compile {rec['compile_s']}s)", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.hillclimb")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--quantized-kv", action="store_true")
    ap.add_argument("--out", default="experiments/perf")
    args = ap.parse_args(argv)
    run(args.arch, args.shape, args.variant, args.out, args.quantized_kv)


if __name__ == "__main__":
    main()
