"""Quickstart on the PyTorch port (twin of ``examples/quickstart.py``):
end-to-end training driver.

Trains a ~100M-parameter decoder-only LM for a few hundred steps on the
deterministic synthetic pipeline, with every framework feature on:
  * F2P8 error-feedback gradient compression (paper-powered): on the card
    one launch of B5's round trip (``ef_roundtrip_kernel``) per step,
  * fault-tolerant checkpointing (atomic, K-last, F2P16-compressed): each
    save encodes the large leaves through B5 (``quantize_kernel``),
  * auto-resume: re-running the script continues from the last checkpoint,
    decoding the F2P16 leaves through B6 (``dequantize_kernel``),
  * F2P-LI telemetry counters for pipeline flow stats.

    PYTHONPATH=src python examples/torch_quickstart.py --steps 300

On the CPU (``--device cpu``) a ~100M model step is slow; --small trains a
~10M variant (same code path) in a couple of minutes.

Differences from the reference, by design: ``--ckpt-dir`` defaults to
``<tempdir>/repro_torch_quickstart_ckpt`` (the reference's is
``/tmp/repro_quickstart_ckpt``), so the twin never resumes from a run of
the reference; the initial state comes from ``torch.Generator`` seed 0, so
the losses are the twin's own (:func:`train` takes a ``state``, e.g. the
reference's carried across by ``models.convert.train_state_from_jax``).
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch import require_device
from repro_torch.data import DataConfig, host_batch
from repro_torch.models.config import ModelConfig, dense_pattern
from repro_torch.optim import AdamWConfig, CompressionConfig
from repro_torch.telemetry import FlowStats
from repro_torch.train import checkpoint, init_train_state, make_train_step


def model_100m():
    return ModelConfig(name="quickstart-100m", n_layers=12, d_model=768,
                       n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32768,
                       pattern=dense_pattern(), dtype="float32", remat=False,
                       rope_theta=10_000.0)


def model_small():
    return ModelConfig(name="quickstart-10m", n_layers=4, d_model=256,
                       n_heads=8, n_kv_heads=4, d_ff=1024, vocab_size=4096,
                       pattern=dense_pattern(), dtype="float32", remat=False,
                       rope_theta=10_000.0)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_quickstart_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-compress", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def train(args, *, device, state=None) -> dict:
    """The quickstart's loop. ``state`` replaces the seeded initial state
    (a checkpoint in ``--ckpt-dir`` still wins, as on any restart). Returns
    ``{"start", "losses" (every step run), "telemetry"}``."""
    cfg = model_small() if args.small else model_100m()
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.1f}M params)")
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    ccfg = CompressionConfig(enabled=not args.no_compress)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    flows = FlowStats(["tokens_in", "steps", "checkpoints"])

    os.makedirs(args.ckpt_dir, exist_ok=True)
    start = checkpoint.latest_step(args.ckpt_dir)
    if state is None:
        state = init_train_state(cfg, ocfg, ccfg, seed=0, device=device)
    if start is not None:
        state, start = checkpoint.restore(args.ckpt_dir, state)
        print(f"resumed from step {start}")
    else:
        start = 0

    step_fn = make_train_step(cfg, ocfg, ccfg)
    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in host_batch(dcfg, step).items()}
        state, m = step_fn(state, batch)
        losses.append(m["loss"])
        flows.add("tokens_in", args.batch * args.seq)
        flows.add("steps")
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"lr {float(m['lr']):.2e} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
        if step > 0 and step % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, step, state, compress=True)
            flows.add("checkpoints")
    checkpoint.save(args.ckpt_dir, args.steps, state, compress=True)
    telemetry = flows.snapshot()
    print("telemetry (F2P-LI counters):", telemetry)
    print("done.")
    return {"start": start, "losses": [float(x) for x in losses],
            "telemetry": telemetry}


def main(argv=None) -> int:
    args = parse_args(argv)
    train(args, device=require_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
