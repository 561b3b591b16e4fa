"""F2P sketch engine demo on the PyTorch port (twin of
``examples/sketch_zipf_trace.py``): ingest a synthetic Zipf packet trace
through the streaming engine and recover the heavy hitters.

1. Generate ~1M packet arrivals over a 1M-flow space, Zipf-1.2 skewed
   (a few elephant flows, a long mouse tail) — the paper's network-
   measurement setting (Sec. III-A).
2. Stream them in odd-sized chunks through `SketchIngestEngine`: re-batched
   into fixed batches, counted by a 4x4096 count-min sketch of 12-bit
   F2P_LI^2 grid-counter cells (32 KiB of registers for 1M flows; the
   12-bit LI^2 range ~2M covers the elephants — 8-bit would saturate at
   ~130k). On the card every batch's advance is one launch of B9
   (``counter_advance_kernel``). The example launches no B10
   (``counter_estimate_kernel``): a query gathers
   ``grid_lut[state[rows, idx]]`` itself, as the reference's does, and
   only ``F2PSketch.estimates()`` launches B10.
3. Print the top-10 report vs ground truth, plus accuracy/throughput stats.
   The trace is streamed twice: the first pass pays compilation (on the
   card, nvcc builds the kernels at first use) and the dense grid head
   (many advance sweeps/cell), the second shows steady state.

    PYTHONPATH=src python examples/torch_sketch_zipf_trace.py [--device cpu]

Differences from the reference, by design: ``SketchConfig`` has no
``backend`` field (the sketch's device decides), so the line that prints
``backend=`` prints ``device=`` instead; the trace and the chunking are
the reference's numpy streams.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch import require_device
from repro_torch.serve.engine import SketchIngestEngine
from repro_torch.sketch import F2PSketch, SketchConfig


def make_trace(n_packets: int, n_flows: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(1.2, size=n_packets)
    # scramble rank -> flow id so heavy flows aren't the small integers
    return (ranks.astype(np.int64) * 0x9E3779B1) % n_flows


def sketch_demo(device, *, n_packets: int = 1 << 20, n_flows: int = 1 << 20,
                sketch=None) -> dict:
    """Stream the trace twice and print the report; returns the top-10
    keys and estimates, the recall and the register KiB. ``sketch``
    replaces the demo's empty 4 x 4096 12-bit LI^2 sketch."""
    trace = make_trace(n_packets, n_flows)

    sk = sketch if sketch is not None else F2PSketch(
        SketchConfig(depth=4, width=4096, n_bits=12, h_bits=2, flavor="li"),
        device=device)
    eng = SketchIngestEngine(sk, batch=1 << 16, track_top=128)

    rng = np.random.default_rng(1)
    rates = []
    for phase in ("cold (compile + dense grid head)", "steady state"):
        t0 = time.perf_counter()
        pos = 0
        while pos < len(trace):  # odd-sized chunks, as a packet feed would
            n = int(rng.integers(10_000, 90_000))
            eng.ingest(trace[pos:pos + n])
            pos += n
        eng.flush()
        dt = time.perf_counter() - t0
        rates.append(len(trace) / dt / 1e6)
        print(f"{phase}: {len(trace):,} packets in {dt:.2f}s "
              f"({rates[-1]:.1f}M arrivals/s)")
    print(f"sketch: {sk.cfg.depth}x{sk.cfg.width} 12-bit F2P_LI^2 cells = "
          f"{sk.nbytes / 1024:.0f} KiB of registers, fill {sk.fill():.0%}, "
          f"device={sk.device}\n")

    # ground truth for the doubled trace (two identical passes)
    uniq, cnt = np.unique(trace, return_counts=True)
    cnt = cnt * 2
    order = np.argsort(cnt)[::-1]
    true_top = {int(k): int(c) for k, c in zip(uniq[order[:10]],
                                               cnt[order[:10]])}

    rep = eng.heavy_hitters(10)
    print("rank  key          estimate      true      err    share")
    for i, (k, e, s) in enumerate(zip(rep.keys, rep.estimates, rep.shares)):
        truth = true_top.get(int(k))
        err = f"{(e - truth) / truth:+7.1%}" if truth else "  (not top-10)"
        print(f"{i:4d}  {int(k):>10d}  {e:>10.0f}  {truth or '-':>8}  {err}"
              f"  {s:6.2%}")
    hit = len(set(rep.keys.tolist()) & set(true_top)) / 10
    print(f"\ntop-10 recall: {hit:.0%}")
    return {"keys": [int(k) for k in rep.keys],
            "estimates": [float(e) for e in rep.estimates],
            "recall": hit, "register_kib": sk.nbytes / 1024}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    sketch_demo(require_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
