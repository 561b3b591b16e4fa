#!/usr/bin/env python3
"""MoE serving on the card: llama4-scout at full width (8 of its 48
layers), and whether one device wait per MoE layer moves its decode. Needs
an NVIDIA GPU.

    python3 tools/moe_bench.py compare   # ~2 min

``compare`` builds scout (random weights, seed 0) and serves chip_smoke
phase 5's workload paged (16 requests, prompts 16..256 tokens, 32 tokens
each, an arrival every 4 decode steps, slots 8, max_seq 1024) under two
variants of the MoE layer: ``models/moe.py`` as it is (``load`` counted by
a scatter-add of ones, no device wait), and the same layer followed by a
read of the count's total back to the host (``wait``: the device wait that
counting with ``torch.bincount`` costs, which reads its output size back).
After a warm-up it runs them in the order as-is, wait, wait, as-is, in one
process, so that a drift of the host shows as the spread of a variant's
runs, and prints each run's tok/s (wall, prefill included) and TBT p50 /
p99; then, per variant, chip_smoke's profiled paged run (2 prefill calls
and 16 decode steps): the device's busy share, the host's waits on the
device and its kernel launches. Results also go to
``chiprun_out/moe_bench.json``.
"""
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def variant(name: str):
    """``wait``: every MoE layer reads its load's total back to the host."""
    from repro_torch.models import moe as M

    orig = M.moe_apply

    def waiting(p, x, cfg):
        out, aux = orig(p, x, cfg)
        aux["load"].sum().item()
        return out, aux

    if name == "wait":
        M.moe_apply = waiting
    try:
        yield
    finally:
        M.moe_apply = orig


def compare() -> dict:
    import dataclasses

    import torch

    import chip_smoke as CS
    from repro_torch.configs import full_config
    from repro_torch.models import init_params

    dev = "cuda"
    smi = CS.smi_line()
    CS.log(f"device   : {smi} | torch {torch.__version__}")
    cfg = dataclasses.replace(full_config("llama4_scout_17b"),
                              n_layers=CS.SCOUT_LAYERS)
    model = init_params(cfg, seed=0, device=dev)
    reqs = CS.family_requests(cfg.vocab_size, 16)
    bs = dict(slots=8, max_seq=1024)
    CS.family_run(dev, cfg, model, reqs, "warm-up", **bs)
    runs = []
    for name in ("as-is", "wait", "wait", "as-is"):
        with variant(name):
            r = CS.family_run(dev, cfg, model, reqs, name, **bs)
        lat = r["latency"]["tbt_ms"]
        runs.append(dict(variant=name, tok_s=r["tok_s"],
                         tbt_p50_ms=lat["p50"], tbt_p99_ms=lat["p99"]))
    prof = {}
    for name in ("as-is", "wait"):
        with variant(name):
            prof[name] = CS.profile_decode(cfg, model, bs)
    for r in runs:
        CS.log(f"moe bench: {r['variant']:6s} {r['tok_s']:.1f} tok/s, TBT "
               f"p50 {r['tbt_p50_ms']:.2f} / p99 {r['tbt_p99_ms']:.2f} ms")
    for name, p in prof.items():
        launches = sum(t["calls"] for t in p["host_top"]
                       if t["name"] in ("cudaLaunchKernel", "cuLaunchKernelEx"))
        CS.log(f"moe bench: {name:6s} profiled: device busy "
               f"{p['device_busy_ms']:.1f} of {p['wall_ms']:.1f} ms "
               f"({100 * p['device_busy_share']:.1f}%), host waits "
               f"{p['host_waits']}, {launches} launches in the host's top "
               "ops")
    out = dict(device=smi, runs=runs, profile=prof)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "moe_bench.json").write_text(json.dumps(out, indent=1,
                                                       default=str))
    return out


def main():
    import torch

    if len(sys.argv) != 2 or sys.argv[1] != "compare":
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("moe_bench.py: no CUDA device")
    compare()


if __name__ == "__main__":
    main()
