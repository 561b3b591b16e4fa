#!/usr/bin/env python3
"""Times one tree's attention kernels (B1/B2), its KV-cache writes (B3),
its KV-cache reads (B4) and its serving path, so that two trees can be set
beside each other in one run on the card. Needs an NVIDIA GPU and the CUDA
toolkit.

    python3 tools/attn_bench.py compare ROOT TAG

ROOT is the root of a checkout (this one, or an older one unpacked with
``git archive`` into a git-ignored directory); its ``src/repro_torch`` is
the code under test, and builds its own kernels. Run the trees in the
order A, B, B, A in one call: the host's noise then shows as the spread
between a tree's two runs.

Kernels: B1/B2 at chip_smoke phase 3's shape (8 rows x 8 kv heads, G = 3,
head_dim 128, kv_len 512..1024 over 8-token pages, ``f2p_sr_2_8s``; f32
and bf16 q) and at phase 6's spans (kv_len 64..81, bf16 q, the page table
cut to 11 pages; and the copy-in call on the full 1024): ``ms`` with CUDA
events around the wrapper (the host included), and from torch.profiler
the attention kernel's device time, all device time and device kernels
per call (the glue launches around the kernel).

KV writes: one layer's decode write at the serving cache (8 slots x 8 kv
heads x head_dim 128, bf16, ``f2p_sr_2_8s``) through the tree's own
``models.attention._paged_cache_write`` (a pool of 1153 8-token pages)
and ``_cache_write`` (copy-in: a [8, 1024] cache, per-slot positions), a
prefill call's write (4 x 256 positions from 0) and B3 on contiguous
[8192, 128] rows (``f2p_quantize_packed``): the same columns, with B3's
kernels (names holding ``quantize_packed``) in place of attention's.

KV reads: B4 through the tree's own ``models.attention._cache_read`` (the
unfused decode's read of one layer's K and V cache, layer 1 of 2 x [1,
1024, 8, 128], ``f2p_sr_2_8s``, bf16 out) and ``f2p_dequantize_packed``
on that layer's K words [8192, 32]: the same columns, B4's kernels (names
holding ``dequantize_packed``).

Serving: chip_smoke phase 5's workload (full-width llama3.2-3b, random
weights from seed 0, 16 requests of 16-256 prompt tokens and 32 new
tokens, an arrival every 4 steps, 8 slots, max_seq 1024) through
``BatchedEngine`` paged and copy-in after a paged warm-up: decode
tokens/s (wall, prefill included) and TBT p50 / p99 from the engine's
obs registry; and phase 6's profile (8 requests of 64 tokens, 2 prefill
calls + 16 decode steps): wall, device busy share, device kernels, and the
attention and B3 kernels' device time per call; then the unfused
sequential ``Engine`` (``ServeConfig``'s default, batch 1, max_seq 1024,
a 64-token prompt): decode ms per token, (a 33-token run - a
1-token run) / 32, the median of 3. Prints one line per measurement,
tagged.
"""
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _inputs(QT, named_format):
    import torch

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(2)
    fmt = named_format("f2p_sr_2_8s")
    B, K, G, hd, T, S = 8, 8, 3, 128, 8, 1024
    maxp = S // T
    P = (B + 1) * maxp + 1
    x = dict(kv_len=torch.randint(512, S + 1, (B,), generator=g, device=dev),
             q=torch.randn(B, 1, K * G, hd, generator=g, device=dev))
    x["slab_k"], x["slab_v"] = (QT.quantize(
        torch.randn(P, T, K, hd, generator=g, device=dev), fmt, block=hd,
        packed=True) for _ in range(2))
    x["pages"] = torch.randperm(P, generator=g, device=dev)[
        :B * maxp].reshape(B, maxp).to(torch.int32)
    x["short"] = torch.randint(64, 82, (B,), generator=g, device=dev)
    x["qb"] = x["q"].to(torch.bfloat16)
    return x


def kernels(tag: str) -> None:
    from repro_torch.core import qtensor as QT
    from repro_torch.core.formats import named_format
    from repro_torch.kernels import f2p_attention as A

    x = _inputs(QT, named_format)
    q, qb, sk, sv, pages = x["q"], x["qb"], x["slab_k"], x["slab_v"], \
        x["pages"]
    dk, dv = A.gather_pages_to_dense(sk, pages), A.gather_pages_to_dense(
        sv, pages)
    span = pages[:, :11].contiguous()
    kv, short = x["kv_len"], x["short"]
    cases = {
        "B1 phase 3, f32 q": lambda: A.attention_paged(q, sk, sv, pages,
                                                       kv_len=kv),
        "B2 phase 3, f32 q": lambda: A.attention_packed(q, dk, dv, kv_len=kv),
        "B1 phase 3, bf16 q": lambda: A.attention_paged(qb, sk, sv, pages,
                                                        kv_len=kv),
        "B1 phase 6 span": lambda: A.attention_paged(qb, sk, sv, span,
                                                     kv_len=short),
        "B2 phase 6 copy-in": lambda: A.attention_packed(qb, dk, dv,
                                                         kv_len=short),
    }
    _report(tag, cases, "attention")


def _report(tag: str, cases: dict, kernel: str) -> None:
    """ms per call with CUDA events around the call (the host included);
    from torch.profiler over 20 calls, the device time of the kernels whose
    names hold ``kernel`` per launch, all device time per call and device
    kernels per call."""
    import torch

    from chip_smoke import _device_events, cuda_ms

    for name, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        ev = _device_events(fn, 20)
        ours = [d for n, d in ev if kernel in n]
        print(f"{tag:8s} {name:24s} ms {cuda_ms(fn, iters=100):.5f}  "
              f"{kernel} kernel {sum(ours) / max(len(ours), 1):8.2f} us "
              f"x {len(ours) / 20:.1f}  "
              f"all device {sum(d for _, d in ev) / 20:8.2f} us  "
              f"device kernels per call {len(ev) / 20:.1f}", flush=True)


def kv_writes(tag: str) -> None:
    """B3 through the tree's own cache writes and contiguous quantize."""
    import torch

    from repro_torch.core.formats import named_format
    from repro_torch.kernels import f2p_quant as Q
    from repro_torch.models import attention as A

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(6)
    fmt = named_format("f2p_sr_2_8s")
    B, K, hd, T, S = 8, 8, 128, 8, 1024
    maxp = S // T
    P = (B + 1) * maxp + 1

    def cache(*lead):
        return {kv: A.empty_packed((*lead, K, hd), fmt, dev)
                for kv in ("k", "v")}

    def rows(*lead):
        return (torch.randn(*lead, K, hd, generator=g, device=dev) * 3).to(
            torch.bfloat16)

    slabs, dense, pf = cache(P, T), cache(B, S), cache(4, 256)
    k, v, kp, vp = rows(B, 1), rows(B, 1), rows(4, 256), rows(4, 256)
    xp = (torch.randn(8192, hd, generator=g, device=dev) * 3).to(
        torch.bfloat16)
    pos = torch.randint(0, S, (B,), generator=g, device=dev)
    pages = (1 + torch.randperm(P - 1, generator=g, device=dev)[
        :B * maxp]).reshape(B, maxp).to(torch.int32)
    _report(tag, {
        "B3 paged decode write": lambda: A._paged_cache_write(
            slabs, k, v, pos, pages),
        "B3 copy-in decode write": lambda: A._cache_write(dense, k, v, pos),
        "B3 prefill write": lambda: A._cache_write(pf, kp, vp, 0),
        "B3 rows [8192, 128]": lambda: Q.f2p_quantize_packed(xp, fmt),
    }, "quantize_packed")


def kv_reads(tag: str) -> None:
    """B4 through the tree's own unfused cache read and single dequantize,
    at one layer of the unfused engine's cache (layer 1 of 2 x [1, 1024, 8,
    128], ``f2p_sr_2_8s``, bf16 out)."""
    import types

    import torch

    from repro_torch.core import qtensor as QT
    from repro_torch.core.formats import named_format
    from repro_torch.kernels import f2p_quant as Q
    from repro_torch.models import attention as A

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(7)
    fmt = named_format("f2p_sr_2_8s")
    stack = {kv: QT.quantize(torch.randn(2, 1, 1024, 8, 128, generator=g,
                                         device=dev) * 3, fmt, block=128,
                             packed=True) for kv in ("k", "v")}
    cache = {kv: QT.QTensor(c.codes[1], c.scales[1], c.fmt, c.block,
                            c.shape[1:], True) for kv, c in stack.items()}
    w = cache["k"].codes.reshape(8192, -1)
    s = cache["k"].scales.reshape(8192, 1)
    cfg = types.SimpleNamespace(torch_dtype=torch.bfloat16)
    _report(tag, {
        "B4 single [8192, 128]": lambda: Q.f2p_dequantize_packed(
            w, s, fmt, out_dtype=torch.bfloat16),
        "B4 K+V layer read": lambda: A._cache_read(cache, cfg),
    }, "dequantize_packed")


def serving(tag: str) -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torch.autograd import DeviceType

    from chip_smoke import device_profile, unfused_tbt
    from repro_torch.configs import full_config
    from repro_torch.models import init_params
    from repro_torch.serve import (BatchedEngine, BatchedServeConfig, Engine,
                                   Request, ServeConfig)

    cfg = full_config("llama3_2_3b")
    model = init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=u + 1,
                    tokens=rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(16, 257))
                                        ).astype(np.int32),
                    max_new=32, arrival=4 * u) for u in range(16)]
    bs = dict(slots=8, max_seq=1024)
    for name, kw in (("warm-up", {}), ("paged", {}),
                     ("copy-in", dict(paged_decode=False))):
        eng = BatchedEngine(cfg, BatchedServeConfig(**bs, **kw), model)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = eng.run(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        ntok = sum(len(v) for v in out.values())
        h = eng.metrics["tbt_ms"]
        print(f"{tag:8s} phase 5 {name:8s} {ntok / dt:8.2f} tok/s  TBT p50 "
              f"{h.quantile(0.5, exact=True):7.2f} / p99 "
              f"{h.quantile(0.99, exact=True):7.2f} ms", flush=True)

    rng = np.random.default_rng(1)
    reqs = [Request(uid=u + 1, tokens=rng.integers(0, cfg.vocab_size, 64),
                    max_new=17) for u in range(8)]
    eng = BatchedEngine(cfg, BatchedServeConfig(**bs), model)
    eng.run(reqs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    res = device_profile(prof, wall_us, ("attention", "quantize_packed"))
    n_dev = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy = res["device_busy_share"]
    line = (f"{tag:8s} phase 6 wall {res['wall_ms']:.1f} ms, device busy "
            f"{res['device_busy_ms']:.1f} ms "
            f"({'not measured' if busy is None else f'{100 * busy:.1f}%'}), "
            f"{n_dev} device kernels")
    for kernel in ("attention", "quantize_packed"):
        ours = [v for k, v in res["kernels"].items() if kernel in k]
        calls = sum(v["calls"] for v in ours)
        per = sum(v["calls"] * v["device_ms_per_call"] for v in ours)
        line += (f", {kernel} {calls} calls, "
                 f"{1e3 * per / max(calls, 1):.2f} us per call")
    print(line, flush=True)

    # the unfused sequential engine (ServeConfig's default)
    eng = Engine(cfg, ServeConfig(batch=1, max_seq=1024, quantized_kv=True),
                 model)
    u = unfused_tbt(eng, reqs[0].tokens[None])
    print(f"{tag:8s} unfused Engine decode {u['ms_per_token']:.3f} ms per "
          f"token (runs {', '.join(f'{p:.3f}' for p in u['runs'])})",
          flush=True)


def compare(root: Path, tag: str) -> None:
    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs import full_config  # noqa: F401
    from repro_torch.core import qtensor  # noqa: F401
    from repro_torch.core import formats  # noqa: F401
    from repro_torch.kernels import cuda as C
    from repro_torch.kernels import f2p_attention  # noqa: F401
    from repro_torch.models import init_params  # noqa: F401
    from repro_torch.serve import BatchedEngine  # noqa: F401

    # after ROOT's package is loaded: chip_smoke puts this tree's src first
    sys.path.insert(0, str(HERE))
    t0 = time.perf_counter()
    C.build()
    C.lib()
    print(f"{tag:8s} {root}: build {time.perf_counter() - t0:.1f} s",
          flush=True)
    kernels(tag)
    kv_writes(tag)
    kv_reads(tag)
    serving(tag)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attn_bench.py: no CUDA device")
    if sys.argv[1:2] == ["compare"] and len(sys.argv) == 4:
        compare(Path(sys.argv[2]).resolve(), sys.argv[3])
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
