"""Autotune study on the PyTorch port (twin of
``examples/autotune_study.py``): the paper's accuracy-vs-range trade-off as
a policy sweep.

Three experiments, all driven by ``repro_torch.autotune``:

  1. RANGE SWEEP — ``sketch.choose_grid`` over widening counting ranges:
     the F2P (flavor, h_bits) partition the closed-form error model picks
     shifts exactly the way the paper's Tables V/VI describe (more
     hyper-exponent only when the range demands it).
  2. POLICY vs BEST SINGLE FORMAT — real FL delta tensors + real KV-cache
     tensors, calibrated per leaf; ``solve()`` allocates formats under the
     same bit budget a uniform 8-bit format spends, with packed-bit
     accounting (``_leaf_bits``: the word-granular bytes packed buffers
     occupy). Acceptance: the policy beats the BEST single hardcoded format
     on combined quantization MSE.
  3. FL ROUND TRADE-OFF — fed-avg with the policy re-solved every K rounds
     from delta histograms vs the fixed ``f2p_sr_2_8``. Acceptance: matches
     or beats the fixed format's wire-bytes/loss trade-off. On the card each
     compressed client leaf is one launch of B5 (``quantize_kernel``) and
     the float server decodes through B6 (``dequantize_kernel``).

    PYTHONPATH=src python examples/torch_autotune_study.py [--quick] \\
        [--device cpu]

The exit code is 1 when part 2 or part 3 fails, as in the reference.

Differences from the reference, by design: the FL toy model, the smoke
llama3.2-3b and its prompt come from ``torch.Generator`` seeds (0, 1, 2),
so parts 2 and 3 measure the twin's own tensors and losses
(:func:`collect_tensors` takes ``fl_params``, ``kv_model`` and
``kv_tokens``, and :func:`part3_fl_tradeoff` a ``task``, to run on the
reference's); part 1 is numpy and prints the reference's lines. Like the
reference, the study imports the private ``fl.rounds._client_batches``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.autotune import (LeafSpec, candidate_formats, leaf_summary,
                                  solve)
from repro_torch.autotune.policy import _leaf_bits, leaf_path_str
from repro_torch.configs import smoke_config
from repro_torch.core.formats import named_format
from repro_torch.fl import (AutotuneConfig, ClientConfig, FedAvgConfig,
                            _tree, run_fed_avg, toy_task)
from repro_torch.fl.client import init_client_residuals, make_client_update
from repro_torch.fl.rounds import _client_batches
from repro_torch.models import init_caches, init_params, prefill
from repro_torch.sketch import choose_grid


# ---------------------------------------------------------------------------
# host-side blockwise round-trip MSE for ANY grid format (F2P or baseline)
# ---------------------------------------------------------------------------
def block_mse(x, fmt, block: int) -> tuple[float, float]:
    """(sum squared error, sum squared signal) of blockwise absmax
    quantization of ``x`` onto ``fmt`` — works for every GridFormat."""
    x = np.asarray(x, np.float64)
    x2 = x.reshape(-1, x.shape[-1])
    n = x2.shape[-1]
    blk = min(block, n)
    pad = (-n) % blk
    if pad:
        x2 = np.pad(x2, ((0, 0), (0, pad)))
    xb = x2.reshape(x2.shape[0], -1, blk)
    absmax = np.abs(xb).max(axis=-1, keepdims=True)
    scale = np.where(absmax > 0, absmax / fmt.max_value, 1.0)
    q = fmt.quantize_value(xb / scale) * scale
    err = ((q - xb) ** 2).reshape(x2.shape)[:, :n]
    return float(err.sum()), float((x * x).sum())


def collect_tensors(quick: bool, *, device, fl_params=None, kv_model=None,
                    kv_tokens=None) -> dict:
    """Real tensors from the two workloads the policy serves: one client's
    FL delta leaves (toy task) and the K/V projections of a prefill on the
    smoke llama config, as numpy arrays by leaf path."""
    tensors = {}

    # FL deltas: one uncompressed client round
    cfg, dcfg, loss_fn, init_fn = toy_task()
    ccfg = ClientConfig(compress=False)
    params = fl_params if fl_params is not None else init_fn(cfg, 0, device)
    client = make_client_update(loss_fn, ccfg)
    fcfg = FedAvgConfig(n_clients=1, rounds=1, client=ccfg)
    delta, _, _ = client(params, init_client_residuals(params, ccfg),
                         _client_batches(dcfg, fcfg, 0, 0, device))
    for path, leaf in _tree.leaves_with_path(delta):
        if leaf.numel() >= 1024:
            tensors["fl/" + leaf_path_str(path)] = leaf.cpu().numpy()

    # KV tensors: unquantized prefill cache of the smoke llama
    mcfg = smoke_config("llama3_2_3b")
    mp = kv_model if kv_model is not None else init_params(mcfg, seed=1,
                                                           device=device)
    S = 16 if quick else 24
    if kv_tokens is None:
        g = torch.Generator().manual_seed(2)
        kv_tokens = torch.randint(0, mcfg.vocab_size, (2, S), generator=g)
    toks = torch.tensor(np.asarray(kv_tokens), dtype=torch.int64,
                        device=device)
    caches = init_caches(mcfg, 2, S, quantized_kv=False, device=device)
    with torch.inference_mode():
        prefill(mp, toks, caches)
    for bname, c in caches.items():
        for part in ("k", "v"):
            tensors[f"kv/{bname}/{part}"] = c[part].to(
                torch.float32).cpu().numpy().reshape(-1, mcfg.head_dim)
    return tensors


def part1_range_sweep():
    print("--- 1. counting-range sweep (choose_grid) ---")
    print(f"{'max_count':>12} {'target':>10}  chosen format        grid max")
    for mc, tr in ((1e3, None), (1e5, None), (1e5, 1e3), (1e7, 1e4),
                   (1e9, 1e6), (4e9, None)):
        fmt, grid = choose_grid(mc, tr)
        print(f"{mc:12.0e} {tr or mc:10.0e}  {str(fmt):<20} {grid[-1]:.3g}")
    print()


def part2_policy_vs_single(tensors, quick: bool) -> bool:
    print("--- 2. per-tensor policy vs best single format "
          "(equal bit budget) ---")
    block = 128
    leaves, data = [], {}
    for path, x in tensors.items():
        dist, srms = leaf_summary(x, block=min(block, x.shape[-1]))
        leaves.append(LeafSpec(path=path, size=int(x.size),
                               last_dim=int(x.shape[-1]), dist=dist,
                               scale_rms=srms))
        data[path] = x

    # the budget a uniform 8-bit format spends on these exact leaves
    total = sum(sp.size for sp in leaves)
    budget = sum(_leaf_bits(sp, "f2p_sr_2_8s", block) for sp in leaves) / total

    singles = candidate_formats(n_bits=(8,), include_baselines=True)
    scores = {}
    for name in singles:
        fmt = named_format(name)
        se = en = 0.0
        for sp in leaves:
            s, e = block_mse(data[sp.path], fmt, block)
            se, en = se + s, en + e
        scores[name] = se / en
    best_single = min(scores, key=scores.get)
    for name in sorted(scores, key=scores.get)[:5]:
        print(f"  single {name:<14} rel-MSE {scores[name]:.3e}")

    policy = solve(leaves, candidate_formats(n_bits=(6, 8, 10)), budget,
                   block=block)
    spent = sum(_leaf_bits(sp, policy.match(sp.path).fmt, block)
                for sp in leaves) / total
    se = en = 0.0
    for sp in leaves:
        fmt = named_format(policy.match(sp.path).fmt)
        s, e = block_mse(data[sp.path], fmt, block)
        se, en = se + s, en + e
    pol_score = se / en
    print(f"  policy ({len(leaves)} leaves, {spent:.2f} vs budget "
          f"{budget:.2f} packed bits/elem) rel-MSE {pol_score:.3e}")
    ratio = pol_score / scores[best_single]
    print(f"  policy vs best single ({best_single}): {ratio:.3f}x")
    ok = pol_score < scores[best_single]
    print(f"  acceptance (policy beats best single at equal budget): "
          f"{'PASS' if ok else 'FAIL'}\n")
    return ok


def part3_fl_tradeoff(quick: bool, *, device, task=None) -> bool:
    print("--- 3. FL rounds: re-solved policy vs fixed f2p_sr_2_8 ---")
    task = task or toy_task()
    rounds = 4 if quick else 6
    clients = 2 if quick else 4
    runs = {}
    for name, at in (("fixed", None), ("autotuned", AutotuneConfig(every=2))):
        fcfg = FedAvgConfig(n_clients=clients, rounds=rounds,
                            client=ClientConfig(compress=True), autotune=at)
        runs[name] = run_fed_avg(fcfg, task, device=device)
    wf, wa = (runs[k]["wire_bytes_per_round"][-1] for k in ("fixed",
                                                            "autotuned"))
    lf, la = (runs[k]["eval_loss"][-1] for k in ("fixed", "autotuned"))
    print(f"  fixed:     wire {wf/1e6:.3f} MB/round, final loss {lf:.4f}")
    print(f"  autotuned: wire {wa/1e6:.3f} MB/round, final loss {la:.4f} "
          f"(re-solved at rounds {runs['autotuned']['resolve_rounds']})")
    ok = wa <= wf * 1.01 and la <= lf * 1.02
    print(f"  acceptance (wire <= fixed, loss <= 1.02x fixed): "
          f"{'PASS' if ok else 'FAIL'}\n")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smaller sweeps (CI smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    part1_range_sweep()
    tensors = collect_tensors(args.quick, device=device)
    ok2 = part2_policy_vs_single(tensors, args.quick)
    ok3 = part3_fl_tradeoff(args.quick, device=device)
    print(f"overall: {'PASS' if ok2 and ok3 else 'FAIL'}")
    return 0 if ok2 and ok3 else 1


if __name__ == "__main__":
    sys.exit(main())
