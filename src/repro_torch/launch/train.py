"""Training launcher (port of ``repro.launch.train``).

Builds the train state, runs the train step with F2P gradient compression
(one launch of B5's round-trip mode per step on the card), writes
checkpoints asynchronously off the critical path (F2P16 payloads quantized
on the card through B5), and survives preemption: on restart it resumes
from the last committed step, bitwise, and with ``--mesh-shape`` on a
DIFFERENT mesh shape if needed (elastic rescale: checkpoints are
mesh-agnostic).

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm_125m \\
        --steps 100 --mesh-shape 2,2 --ckpt-dir /path/to/run1

The flags are the reference's, and so are the defaults (``--arch
xlstm_125m``) apart from ``--ckpt-dir``: ``<tempdir>/repro_torch_train_ckpt``
(the reference's is ``/tmp/repro_train_ckpt``: the port's checkpoints go
to a directory of their own, under the process's temporary directory).
``--log-every`` (default 10, the reference's fixed interval) sets how
often the loss is logged.

``--mesh-shape d,m`` other than ``1,1`` trains on a ("data", "model")
DeviceMesh of d·m ranks: the launcher starts them as processes of its own
(or joins a world ``torchrun`` has already set up: ``RANK`` and
``WORLD_SIZE`` in the environment). With at least as many cards as ranks
they run over NCCL, one card each; with more ranks than cards over gloo,
ranks sharing the cards round-robin. ``--device cpu`` runs every rank
(or the one process of ``1,1``) on the CPU over gloo; the default,
``cuda``, needs a card and exits with an error naming ``--device cpu``
where there is none. The first line names the backend and each rank's
device. The state is
sharded by the reference's logical rules (``launch.shardings``); the
step is ``train.step.sharded_train_step``. Rank 0 prints the step,
resume and ``done.`` lines, then a "ranks" line (each rank's state bytes,
peak memory and step time, and what the model axis splits) and a "legs"
line (each named collective's calls and bytes a step); ``--die-at-step``
logs those two lines and exits every rank with 42, and the launcher then
returns 42.

Every other config of the reference trains, the MoE family (llama4,
jamba) included: its gradients are compressed at the bare ``"grad"``
path's block of 128, as the reference's CLI asks the policy for them.
The data pipeline makes tokens and labels only, as the reference's:
``--arch internvl2_1b`` trains text only and ``--arch whisper_large_v3``
fails at its first step with a ``KeyError`` naming ``frames``, as the
reference's CLI does. ``main`` parses the flags; :func:`run` takes a
config, so a caller can train a configuration of its own choosing (fewer
layers, a narrower batch) through the same loop, on a mesh with
``mesh_shape`` inside a world it has set up.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import socket
import subprocess
import sys
import tempfile
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="xlstm_125m")
    ap.add_argument("--full", action="store_true",
                    help="use the full assigned config (default: smoke)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh-shape", default="1,1",
                    help="data,model (ranks started by the launcher)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--die-at-step", type=int, default=-1,
                    help="simulate preemption (exit hard at this step)")
    ap.add_argument("--no-compress", action="store_true")
    ap.add_argument("--log-every", type=int, default=10,
                    help="log the loss every this many steps")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the ranks run (cpu: gloo ranks on the CPU)")
    return ap.parse_args(argv)


def train_configs(cfg, *, arch: str, steps: int, global_batch: int = 8,
                  seq: int = 128, compress: bool = True):
    """The reference launcher's optimizer, compression, data configs and
    format policy: AdamW lr 1e-3 with warmup 10, gradient formats from the
    arch's default FormatPolicy (configs.registry), min_size 512."""
    from repro_torch.configs import default_policy
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig, CompressionConfig

    ocfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps)
    policy = default_policy(arch)
    gfmt, gblock = policy.f2p_for("grad", (CompressionConfig.fmt, 128))
    ccfg = CompressionConfig(enabled=compress, min_size=512, fmt=gfmt,
                             block=gblock)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=global_batch)
    return ocfg, ccfg, dcfg, policy


def run(cfg, *, arch: str, steps: int, global_batch: int = 8, seq: int = 128,
        ckpt_dir: str, ckpt_every: int = 20, die_at_step: int = -1,
        compress: bool = True, device="cuda", log=print, mesh_shape=None,
        log_every: int = 10):
    """Train ``cfg`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    latest committed step), checkpointing every ``ckpt_every`` steps and at
    the end, and logging the loss every ``log_every`` steps and at the
    last. Returns (state, info): ``info`` holds the first step run
    (``start``), each step's metrics as floats (``history``) and seconds
    (``step_s``, device synced by reading the metrics), and the
    checkpointer's snapshot and write seconds (``ckpt``).

    ``mesh_shape`` (d, m): train on a ("data", "model") DeviceMesh of the
    process group this process belongs to (``init_process_group`` done by
    the caller, world size d·m); every rank calls ``run``, each takes its
    data slice of the batch, and only rank 0 logs and writes checkpoints.
    ``info`` then also has ``mesh``, ``split``
    (``launch.shardings.split_plan``), ``ranks`` and ``legs``
    (:func:`_mesh_report`) and ``state_bytes`` (this rank's bytes of
    parameters, moments and residuals)."""
    import torch

    from repro_torch.data import host_batch
    from repro_torch.launch import mesh as M
    from repro_torch.train import (checkpoint, init_train_state,
                                   make_train_step)
    from repro_torch.train.async_ckpt import AsyncCheckpointer

    ocfg, ccfg, dcfg, policy = train_configs(
        cfg, arch=arch, steps=steps, global_batch=global_batch, seq=seq,
        compress=compress)
    dev = torch.device(device)
    rank, dcoord, dsize, mesh = 0, 0, 1, None
    if mesh_shape is not None:
        import torch.distributed as dist

        from repro_torch.launch.mesh import compat_make_mesh, mesh_shape as ms
        from repro_torch.launch.shardings import (rules_for, split_plan,
                                                  split_text,
                                                  train_state_specs)
        from repro_torch.models.sharding import logical_rules

        rank = dist.get_rank()
        if rank:
            log = _quiet
        mesh = compat_make_mesh(mesh_shape, ("data", "model"), dev)
        rules = rules_for(cfg, mesh, "train_4k")
        dcoord, dsize = mesh.get_coordinate()[0], mesh.size(0)
        if global_batch % dsize:
            raise ValueError(f"--global-batch {global_batch} does not split "
                             f"over {dsize} data ranks")
        log(f"mesh {ms(mesh)}  arch {cfg.name} "
            f"({cfg.param_count() / 1e6:.1f}M params)")
    else:
        log(f"device {device}  arch {cfg.name} "
            f"({cfg.param_count() / 1e6:.1f}M params)")
    shardings = (None if mesh is None else
                 train_state_specs(cfg, ocfg, ccfg, mesh, rules)[0])
    state = init_train_state(cfg, ocfg, ccfg, seed=0, device=device,
                             shardings=shardings)
    if mesh is not None:
        plan = split_plan(cfg, dict(state["params"].named_parameters()))
        log(split_text(plan))
    start = _agreed(checkpoint.latest_step(ckpt_dir), mesh)
    if start is not None:
        state, start = checkpoint.restore(ckpt_dir, state, step=start)
        log(f"resumed from step {start}"
            + (" (elastic remesh ok)" if mesh is not None else ""))
    else:
        start = 0
        os.makedirs(ckpt_dir, exist_ok=True)
    step_fn = make_train_step(cfg, ocfg, ccfg)
    ckpt = AsyncCheckpointer(ckpt_dir, keep=3, policy=policy,
                             writer=rank == 0)
    history, seconds = [], []
    ctx = (logical_rules(rules, mesh) if mesh is not None
           else contextlib.nullcontext())
    try:
        with ctx:
            for step in range(start, steps):
                if step == die_at_step:
                    if mesh is not None:   # the ranks' steps before it
                        _mesh_report(state, seconds, dev, plan, log)
                    log(f"SIMULATED PREEMPTION at step {step}")
                    sys.stdout.flush()
                    os._exit(42)
                batch = {k: torch.from_numpy(v).to(dev) for k, v in
                         host_batch(dcfg, step, process_index=dcoord,
                                    process_count=dsize).items()}
                if step == start + 1:
                    M.reset_legs()   # the legs of the steps after the first
                t = time.perf_counter()
                state, m = step_fn(state, batch)
                m = {k: float(v) for k, v in m.items()}   # syncs the device
                seconds.append(time.perf_counter() - t)
                history.append(m)
                if step % log_every == 0 or step == steps - 1:
                    log(f"step {step:4d} loss {m['loss']:.4f} "
                        f"gnorm {m['grad_norm']:.3f}")
                if step > 0 and step % ckpt_every == 0:
                    ckpt.save(step, state)   # async, off the critical path
            ckpt.save(steps, state)
            ckpt.wait()
            if mesh is not None:
                torch.distributed.barrier()   # the final write is durable
    finally:
        ckpt.close()
    info = dict(start=start, history=history, step_s=seconds,
                ckpt=ckpt.stats)
    if mesh is not None:
        info.update(mesh=ms(mesh), split=plan,
                    **_mesh_report(state, seconds, dev, plan, log))
        info["state_bytes"] = info["ranks"][rank]["state_bytes"]
    log("done.")
    return state, info


def _mesh_report(state, seconds: list, dev, plan: dict, log) -> dict:
    """``{"ranks": _rank_stats, "legs": rank 0's train legs a step (calls,
    bytes; the steps after the first)}``, logged on a "ranks" line (each
    rank's state, peak and step, and the model-axis split) and a "legs"
    line. A collective: every rank calls it."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch.shardings import split_text

    n = max(len(seconds) - 1, 1)
    legs = {k: (c // n, b // n) for k, (c, b) in sorted(M.LEGS.items())
            if k.startswith("train.")}
    ranks = _rank_stats(state, seconds, dev, legs)
    log("ranks " + " | ".join(
        f"{r}: state {a['state_bytes']} B, peak {a['peak_bytes']} B, "
        f"step {a['step_ms']:.1f} ms" for r, a in enumerate(ranks))
        + f" | {split_text(plan)}")
    log("legs a step (rank 0: calls, bytes) " + ", ".join(
        f"{k} {c} {b} B" for k, (c, b) in legs.items()))
    return dict(ranks=ranks, legs=legs)


def _rank_stats(state, seconds: list, dev, legs: dict) -> list:
    """Every rank's bytes of state, peak device bytes (0 on the CPU),
    median step milliseconds and legs a step, gathered to all ranks."""
    import statistics

    import torch
    import torch.distributed as dist

    mine = dict(state_bytes=local_state_bytes(state),
                peak_bytes=(torch.cuda.max_memory_allocated(dev)
                            if dev.type == "cuda" else 0),
                step_ms=1e3 * statistics.median(seconds) if seconds else 0.0,
                legs=legs)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, mine)
    return out


def _quiet(*_):
    pass


def _agreed(value, mesh):
    """Rank 0's ``value`` on every rank of the mesh (plain without one)."""
    if mesh is None:
        return value
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def local_state_bytes(state) -> int:
    """Bytes of this rank's parameters, moments and residuals (the local
    shard of each DTensor)."""
    from torch.distributed.tensor import DTensor

    def nbytes(t):
        t = t.to_local() if isinstance(t, DTensor) else t
        return t.numel() * t.element_size()

    total = sum(nbytes(p.data) for p in state["params"].parameters())
    for key in ("mu", "nu"):
        total += sum(nbytes(t) for t in state["opt"][key].values())
    return total + sum(nbytes(t) for t in state["residuals"].values()
                       if t is not None)


def mesh_backend(world: int, device: str = "cuda") -> tuple[str, list]:
    """(backend, device of each rank) for a world of ``world`` ranks on
    ``device``: on the CPU gloo; on cards NCCL with one card each where
    there are enough, else gloo, ranks sharing the cards round-robin.
    Cards asked for where there is none raise, naming ``--device cpu``."""
    import torch

    if device == "cpu":
        return "gloo", ["cpu"] * world
    cards = torch.cuda.device_count()
    if not cards:
        raise RuntimeError("no CUDA device: the ranks run on the card unless "
                           "--device cpu asks for the CPU")
    if cards >= world:
        return "nccl", [f"cuda:{r}" for r in range(world)]
    return "gloo", [f"cuda:{r % cards}" for r in range(world)]


def parse_mesh_shape(text: str) -> tuple[int, int]:
    try:
        shape = tuple(int(x) for x in text.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"--mesh-shape {text!r}: expected data,model, two "
                         "positive integers")
    return shape


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch_ranks(argv: list, world: int) -> int:
    """Start ``world`` ranks of this CLI (RANK / WORLD_SIZE / MASTER_* in
    their environment) and wait for them. Returns the first non-zero exit
    code (a rank that fails stops the others), else 0."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *argv],
            env=env))
    first, deadline = 0, None
    try:
        while any(p.poll() is None for p in procs):
            if not first:
                first = next((p.returncode for p in procs if p.returncode),
                             0)
                if first:   # the others may wait in a collective: 30 s
                    deadline = time.monotonic() + 30
            if deadline is not None and time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return first or next((p.returncode for p in procs if p.returncode), 0)


def _rank_main(args, shape) -> None:
    """One rank of a mesh run: join the world, train, leave."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import full_config, smoke_config

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if world != shape[0] * shape[1]:
        raise ValueError(f"--mesh-shape {args.mesh_shape} needs "
                         f"{shape[0] * shape[1]} ranks; the world has {world}")
    backend, devices = mesh_backend(world, args.device)
    device = devices[rank]
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    else:   # CPU ranks split the cores instead of each taking all of them
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    try:
        if rank == 0:
            print(f"backend {backend}  ranks "
                  + " ".join(f"{r}:{d}" for r, d in enumerate(devices)),
                  flush=True)
        cfg = full_config(args.arch) if args.full else smoke_config(args.arch)
        run(cfg, arch=args.arch, steps=args.steps,
            global_batch=args.global_batch, seq=args.seq,
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            die_at_step=args.die_at_step, compress=not args.no_compress,
            device=device, mesh_shape=shape, log_every=args.log_every)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    shape = parse_mesh_shape(args.mesh_shape)
    try:
        mesh_backend(shape[0] * shape[1], args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        _rank_main(args, shape)
        return 0
    if shape != (1, 1):
        return _launch_ranks(argv, shape[0] * shape[1])
    from repro_torch.configs import full_config, smoke_config

    cfg = full_config(args.arch) if args.full else smoke_config(args.arch)
    run(cfg, arch=args.arch, steps=args.steps,
        global_batch=args.global_batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, die_at_step=args.die_at_step,
        compress=not args.no_compress, device=args.device,
        log_every=args.log_every)
    return 0


if __name__ == "__main__":
    sys.exit(main())
