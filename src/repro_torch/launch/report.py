"""The roofline / dry-run tables from the dry run's JSON records (port of
``repro.launch.report``, text for text).

    PYTHONPATH=src python -m repro_torch.launch.report experiments/dryrun_torch
"""
from __future__ import annotations

import glob
import json
import os
import sys


def load(out_dir: str):
    recs = []
    for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def fmt_s(x):
    if x is None:
        return "-"
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def dryrun_table(recs, mesh: str):
    rows = ["| arch | shape | status | compile_s | HLO flops/dev | arg+tmp GB/dev | collectives |",
            "|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['status']}"
                        f" | - | - | - | {r.get('reason', r.get('error',''))[:60]} |")
            continue
        mem = r.get("memory_per_device", {})
        gb = (mem.get("argument_size_in_bytes", 0) +
              mem.get("temp_size_in_bytes", 0)) / 1e9
        ops = ", ".join(f"{k}:{int(v['count'])}" for k, v in
                        sorted(r.get("per_op", {}).items()))
        rows.append(f"| {r['arch']} | {r['shape']} | ok | {r['compile_s']}"
                    f" | {r['hlo_flops']:.2e} | {gb:.1f} | {ops} |")
    return "\n".join(rows)


def roofline_table(recs, mesh: str = "16x16"):
    rows = ["| arch | shape | t_compute | t_memory | t_collective | bottleneck"
            " | MODEL_FLOPS | useful | roofline_frac | what would move the dominant term |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["mesh"] != mesh or r["status"] != "ok":
            continue
        hint = _hint(r)
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['t_compute'])} "
            f"| {fmt_s(r['t_memory'])} | {fmt_s(r['t_collective'])} "
            f"| **{r['bottleneck']}** | {r['model_flops']:.2e} "
            f"| {r['useful_flops_ratio']:.2f} | {r['roofline_fraction']:.3f} "
            f"| {hint} |")
    return "\n".join(rows)


def _hint(r):
    b = r["bottleneck"]
    kind = r.get("kind", "")
    per = r.get("per_op", {})
    if b == "collective":
        big = max(per.items(), key=lambda kv: kv[1]["moved"])[0] if per else "?"
        return (f"cut {big} traffic: fuse/reshard the dominant resharding, "
                "overlap with compute, compress payloads (F2P8)")
    if b == "memory":
        if kind == "decode":
            return "shrink KV/state reads: F2P8 KV cache, larger batch per chip"
        return "avoid score materialization (chunked attention), fuse, remat less"
    return "increase per-chip arithmetic intensity or reduce redundant flops"


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch"
    recs = load(out_dir)
    ok = sum(r["status"] == "ok" for r in recs)
    sk = sum(r["status"] == "skipped" for r in recs)
    er = sum(r["status"] == "error" for r in recs)
    print(f"## Dry-run summary: {ok} ok, {sk} skipped (documented), {er} failed\n")
    for mesh in ("16x16", "2x16x16"):
        print(f"### Mesh {mesh}\n")
        print(dryrun_table(recs, mesh))
        print()
    print("### Roofline (single pod, 16x16)\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
