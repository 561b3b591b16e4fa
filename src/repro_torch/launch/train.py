"""Training launcher (port of ``repro.launch.train``), one card.

Builds the train state, runs the train step with F2P gradient compression
(one launch of B5's round-trip mode per step on the card), writes
checkpoints asynchronously off the critical path (F2P16 payloads quantized
on the card through B5), and survives preemption: on restart it resumes
from the last committed step, bitwise.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm_125m \\
        --full --steps 8 --ckpt-dir /path/to/run1

The flags are the reference's, and so are the defaults (``--arch
xlstm_125m``) apart from ``--ckpt-dir``: ``<tempdir>/repro_torch_train_ckpt``
(the reference's is ``/tmp/repro_train_ckpt``: the port's checkpoints go
to a directory of their own, under the process's temporary directory).
Only ``--mesh-shape 1,1`` runs: data and model parallelism over several
cards is ROADMAP A12 (sharded part). Every other config of the reference
trains, the MoE family (llama4, jamba) included: its gradients are
compressed at the bare ``"grad"`` path's block of 128, as the reference's
CLI asks the policy for them. The data pipeline makes tokens and labels
only, as the reference's: ``--arch internvl2_1b`` trains text only and
``--arch whisper_large_v3`` fails at its first step with a ``KeyError``
naming ``frames``, as the reference's CLI does. ``main`` parses the flags; :func:`run` takes
a config, so a caller can train a configuration of its own choosing
(fewer layers, a narrower batch) through the same loop.
"""
from __future__ import annotations

import argparse
import os
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
                    help="data,model: only 1,1 (one card) is ported")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--die-at-step", type=int, default=-1,
                    help="simulate preemption (exit hard at this step)")
    ap.add_argument("--no-compress", action="store_true")
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
        compress: bool = True, device="cuda", log=print):
    """Train ``cfg`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    latest committed step), checkpointing every ``ckpt_every`` steps and at
    the end. Returns (state, info): ``info`` holds the first step run
    (``start``), each step's metrics as floats (``history``) and seconds
    (``step_s``, device synced by reading the metrics), and the
    checkpointer's snapshot and write seconds (``ckpt``)."""
    import torch

    from repro_torch.data import host_batch
    from repro_torch.train import (checkpoint, init_train_state,
                                   make_train_step)
    from repro_torch.train.async_ckpt import AsyncCheckpointer

    ocfg, ccfg, dcfg, policy = train_configs(
        cfg, arch=arch, steps=steps, global_batch=global_batch, seq=seq,
        compress=compress)
    log(f"device {device}  arch {cfg.name} "
        f"({cfg.param_count() / 1e6:.1f}M params)")
    state = init_train_state(cfg, ocfg, ccfg, seed=0, device=device)
    start = checkpoint.latest_step(ckpt_dir)
    if start is not None:
        state, start = checkpoint.restore(ckpt_dir, state)
        log(f"resumed from step {start}")
    else:
        start = 0
        os.makedirs(ckpt_dir, exist_ok=True)
    step_fn = make_train_step(cfg, ocfg, ccfg)
    ckpt = AsyncCheckpointer(ckpt_dir, keep=3, policy=policy)
    dev = torch.device(device)
    history, seconds = [], []
    try:
        for step in range(start, steps):
            if step == die_at_step:
                log(f"SIMULATED PREEMPTION at step {step}")
                os._exit(42)
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in host_batch(dcfg, step).items()}
            t = time.perf_counter()
            state, m = step_fn(state, batch)
            m = {k: float(v) for k, v in m.items()}   # syncs the device
            seconds.append(time.perf_counter() - t)
            history.append(m)
            if step % 10 == 0 or step == steps - 1:
                log(f"step {step:4d} loss {m['loss']:.4f} "
                    f"gnorm {m['grad_norm']:.3f}")
            if step > 0 and step % ckpt_every == 0:
                ckpt.save(step, state)   # async, off the critical path
        ckpt.save(steps, state)
        ckpt.wait()
    finally:
        ckpt.close()
    log("done.")
    return state, dict(start=start, history=history, step_s=seconds,
                       ckpt=ckpt.stats)


def main(argv=None):
    args = parse_args(argv)
    shape = tuple(int(x) for x in args.mesh_shape.split(","))
    if shape != (1, 1):
        raise NotImplementedError(
            f"--mesh-shape {args.mesh_shape}: training over several cards "
            "is ROADMAP A12 (sharded part); the port trains on one card "
            "(1,1)")
    from repro_torch.configs import full_config, smoke_config

    cfg = full_config(args.arch) if args.full else smoke_config(args.arch)
    run(cfg, arch=args.arch, steps=args.steps,
        global_batch=args.global_batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, die_at_step=args.die_at_step,
        compress=not args.no_compress)


if __name__ == "__main__":
    main()
