"""Federated averaging with F2P8-quantized client updates on the PyTorch
port (twin of ``examples/fed_avg.py``; the paper's FL claim).

Runs the fed-avg simulation three ways on the toy LM — clients shipping raw
f32 deltas, F2P8 QTensor deltas (codes + per-block scales, error feedback),
and bit-packed deltas under an autotuned mixed 6/8-bit policy — and reports
the wire-byte reductions and final-loss ratios. On the card every
compressed client leaf is one launch of B5 (``quantize_kernel``, codes) or
B3 (``quantize_packed_write_kernel``, packed words), and the float server
decodes through B6 (``dequantize_kernel``) or B4
(``dequantize_packed_kernel``).

    PYTHONPATH=src python examples/torch_fed_avg.py [--rounds 5] \\
        [--clients 4] [--device cpu]

Acceptance, as the reference's: >= 3.5x fewer wire bytes per round at
<= 1.05x the f32 final loss for the fixed F2P8 run, and a further >= 20%
wire drop at <= 1.001x the F2P8 loss for the packed mixed policy; the exit
code is 1 when either fails. The port has no ``F2P_PACKED`` switch: its
``packed=None`` defaults stay unpacked, and only the packed-mixed run ships
packed words.

Chaos mode: ``--faults chaos-small`` runs the straggler-tolerant fleet
driver twice — fault-free and under a seeded FaultPlan (20% dropout, 10%
stragglers, NaN/bit-flip wire corruption) — and enforces by exit code that
the faulted run lands within 1.05x the fault-free final loss and never
commits a non-finite global model. As in the reference, an
``AggregationOverflow`` raised by a corrupted update is not caught.

Differences from the reference, by design: the toy model's initial
parameters come from the port's seeded init (``torch.Generator`` seed 0),
so the losses are the twin's own; :func:`run_comparison` and
:func:`run_chaos` take a ``task`` whose init returns other parameters (the
reference's, carried across by ``models.convert.params_tree_from_jax``).
"""
import argparse
import dataclasses
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.faults import named_plan
from repro_torch.fl import (AutotuneConfig, ClientConfig, FedAvgConfig,
                            FleetConfig, _tree, run_fed_avg,
                            run_fleet_rounds, toy_task)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--packed-budget", type=float, default=6.5,
                    help="bits/elem budget of the packed mixed 6/8 policy")
    ap.add_argument("--faults", type=str, default="",
                    help="run the fleet driver under this named FaultPlan "
                         "(e.g. chaos-small) instead of the 3-way comparison")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run_chaos(args, *, device, task=None) -> int:
    """Fault-free vs faulted fleet rounds on the same seeded cohort;
    returns the exit status."""
    task = task or toy_task()
    ccfg = dataclasses.replace(FleetConfig().client,
                               local_steps=args.local_steps, lr=args.lr)
    flcfg = FleetConfig(n_clients=max(args.clients, 32),
                        sample=max(args.clients, 32),
                        quorum=max(args.clients, 32) // 4,
                        rounds=args.rounds, client=ccfg)
    print(f"--- fleet fault-free ({flcfg.sample} clients x "
          f"{flcfg.rounds} rounds) ---")
    clean = run_fleet_rounds(flcfg, task, device=device, verbose=True)
    print(f"--- fleet under FaultPlan '{args.faults}' ---")
    chaos = run_fleet_rounds(flcfg, task, faults=named_plan(args.faults),
                             device=device, verbose=True)

    finite = all(bool(torch.isfinite(leaf).all())
                 for leaf in _tree.leaves(chaos["params"]))
    ratio = chaos["eval_loss"][-1] / clean["eval_loss"][-1]
    quarantined = int(np.sum(chaos["quarantined"]))
    dropped = int(np.sum(chaos["dropped"]))
    print("\nchaos summary:")
    print(f"  final eval loss: clean {clean['eval_loss'][-1]:.4f} vs faulted "
          f"{chaos['eval_loss'][-1]:.4f} ({ratio:.4f}x)")
    print(f"  faulted run: {dropped} drops, {quarantined} quarantined "
          f"updates, {int(np.sum(chaos['committed']))} committed rounds")
    ok = ratio <= 1.05 and finite and math.isfinite(chaos["eval_loss"][-1])
    print(f"  acceptance (<=1.05x fault-free loss, finite model): "
          f"{'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def run_comparison(args, *, device, task=None) -> int:
    """The three-way comparison; returns the exit status."""
    task = task or toy_task()
    configs = {
        "f32": (ClientConfig(local_steps=args.local_steps, lr=args.lr,
                             compress=False), None),
        "f2p8": (ClientConfig(local_steps=args.local_steps, lr=args.lr,
                              compress=True), None),
        # packed wire + mixed-width policy re-solved from delta histograms:
        # 6-bit where the error model says it is free, 8-bit elsewhere
        "f2p packed-mixed": (
            ClientConfig(local_steps=args.local_steps, lr=args.lr,
                         compress=True, packed=True),
            AutotuneConfig(every=2, n_bits=(6, 8),
                           budget_bits_per_elem=args.packed_budget)),
    }
    runs = {}
    for name, (ccfg, at) in configs.items():
        fcfg = FedAvgConfig(n_clients=args.clients, rounds=args.rounds,
                            client=ccfg, autotune=at)
        print(f"--- {name} client updates "
              f"({args.clients} clients x {args.rounds} rounds x "
              f"{args.local_steps} local steps) ---")
        runs[name] = run_fed_avg(fcfg, task, device=device, verbose=True)

    wire = {k: r["wire_bytes_per_round"][-1] for k, r in runs.items()}
    loss = {k: r["eval_loss"][-1] for k, r in runs.items()}
    print("\nsummary:")
    print(f"  wire bytes/round: f32 {wire['f32']/1e6:.2f} MB -> "
          f"f2p8 {wire['f2p8']/1e6:.2f} MB "
          f"({wire['f32']/wire['f2p8']:.2f}x reduction)")
    print(f"  final eval loss:  f32 {loss['f32']:.4f} vs f2p8 "
          f"{loss['f2p8']:.4f} ({loss['f2p8']/loss['f32']:.3f}x)")
    packed_drop = 1.0 - wire["f2p packed-mixed"] / wire["f2p8"]
    packed_loss = loss["f2p packed-mixed"] / loss["f2p8"]
    print(f"  packed mixed policy: wire {wire['f2p packed-mixed']/1e6:.2f} MB "
          f"({packed_drop:.1%} below f2p8) at {packed_loss:.4f}x f2p8 loss")
    ok = wire["f32"] / wire["f2p8"] >= 3.5 and loss["f2p8"] <= 1.05 * loss["f32"]
    ok_packed = packed_drop >= 0.20 and packed_loss <= 1.001
    print(f"  acceptance (>=3.5x wire, <=1.05x loss): "
          f"{'PASS' if ok else 'FAIL'}")
    print(f"  acceptance (packed: >=20% wire drop, <=1.001x f2p8 loss): "
          f"{'PASS' if ok_packed else 'FAIL'}")
    return 0 if ok and ok_packed else 1


def main(argv=None) -> int:
    args = parse_args(argv)
    device = require_device(args.device)
    if args.faults:
        return run_chaos(args, device=device)
    return run_comparison(args, device=device)


if __name__ == "__main__":
    sys.exit(main())
