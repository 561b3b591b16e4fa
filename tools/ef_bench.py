#!/usr/bin/env python3
"""Times one tree's unpacked quantize (B5) and its gradient compression
round trip at full llama3.2-3b width, so that two trees can be set beside
each other in one run on the card. Needs an NVIDIA GPU and the CUDA
toolkit.

    python3 tools/ef_bench.py sass              # this tree's B5 build report
    python3 tools/ef_bench.py compare ROOT TAG  # one tree's timings

ROOT is the root of a checkout (this one, or an older one unpacked with
``git archive`` into a git-ignored directory); its ``src/repro_torch`` is
the code under test and builds its own kernels. Run the trees in the
order A, B, B, A in one call: the host's noise then shows as the spread
between a tree's two runs.

``sass``: nvcc's register / spill lines for the quantize kernels and, from
``cuobjdump -sass`` on the built library, the SASS instruction count of
each of their instances; the listings go to ``chiprun_out/b5_sass.txt``.

``compare``, each line tagged:

* B5 per train step: ``f2p_quantize_codes`` once per leaf of the full
  llama3.2-3b train state (255 leaves, 3,606,759,936 elements, f32 in,
  randn x 1e-3 from torch.Generator seed 4), 8-bit ``f2p_sr_2_8s`` and
  16-bit ``f2p_sr_2_16s`` (f32 scales), the sum over the leaf shapes of
  their count x ms per call: with the host (CUDA events around 20 calls)
  and on the device (torch.profiler, all kernels of the calls).
* Compression per train step: the tree's ``compress_decompress`` over the
  model's named gradients (bf16, randn x 1e-3, seed 5) and f32 residuals
  (zero, then one warm-up call), ``train_configs``' compression config
  (``f2p_sr_2_8s``, block 128, min_size 512, error feedback): ms per call
  with the host (CUDA events around 5 calls) and on the device, device
  kernels per call, the peak of allocated memory above the inputs, and a
  digest of the gradients' and residuals' bits after the timed calls
  (equal digests: the trees agree bit for bit).
* Train step: ``make_train_step`` on ``init_train_state`` (seed 0), 7
  steps of ``data.host_batch`` (batch 8 x seq 128): ms per step over steps
  2-6 (host clock to a synchronize), tokens/s, peak allocated memory, and
  from torch.profiler over step 1 the device's busy ms and share, device
  kernels, and the device ms of the kernels whose names hold
  ``quantize``.
"""
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ARCH = "llama3_2_3b"


def sass() -> None:
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.kernels import cuda as C

    lib = C.build()
    C.lib()
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    lines = C.build_log.splitlines()
    for i, line in enumerate(lines):
        if "quantize_kernel" in line or "ef_roundtrip" in line:
            for ln in lines[i:i + 4]:
                if "Compiling" in ln or "registers" in ln or "spill" in ln:
                    print("ptxas  :", ln.strip(), flush=True)
    cuobjdump = Path(C._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    keep, cur, n = [], None, {}
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if ("quantize_kernel" in m.group(1)
                                 or "roundtrip" in m.group(1)) else None
            if cur:
                n[cur] = 0
        if cur:
            keep.append(line)
            if re.search(r"/\*[0-9a-f]{4}\*/", line):
                n[cur] += 1
    (out / "b5_sass.txt").write_text("\n".join(keep))
    for name, count in n.items():
        print(f"sass   : {count:6d} instructions  {name}", flush=True)


def _digest(ts) -> int:
    import torch

    h = 0
    for t in ts:
        v = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
        h = (h * 1000003 + int(v.to(torch.int64).sum())) % (1 << 61)
    return h


def b5_per_step(tag: str) -> None:
    import gc

    import torch

    from chip_smoke import _device_events, cuda_ms, train_leaf_counts
    from repro_torch.configs import full_config
    from repro_torch.core.formats import named_format
    from repro_torch.kernels import f2p_quant as Q

    g = torch.Generator(device="cuda").manual_seed(4)
    counts = train_leaf_counts(full_config(ARCH))
    xs = {s: torch.randn(*s, generator=g, device="cuda").reshape(-1, s[-1])
          * 1e-3 for s in counts}
    for name in ("f2p_sr_2_8s", "f2p_sr_2_16s"):
        fmt = named_format(name)
        host = dev = 0.0
        for s, count in counts.items():
            def fn(x=xs[s]):
                return Q.f2p_quantize_codes(x, fmt)
            host += count * cuda_ms(fn, iters=20)
            ev = _device_events(fn, 10)
            dev += count * sum(d for _, d in ev) / 10 / 1e3
            gc.collect()   # the profiler's events, out of the next timing
        print(f"{tag:8s} B5 {name:13s} per step: {host:9.3f} ms with the "
              f"host, {dev:9.3f} ms on the device", flush=True)
    del xs
    torch.cuda.empty_cache()


def compression(tag: str) -> None:
    import torch

    from chip_smoke import _device_events
    from repro_torch.configs import full_config
    from repro_torch.launch.train import train_configs
    from repro_torch.models import init_params
    from repro_torch.optim.compress import compress_decompress, init_residuals

    cfg = full_config(ARCH)
    ccfg = train_configs(cfg, arch=ARCH, steps=8)[1]
    model = init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    grads = {n: (torch.randn(p.shape, generator=g, device="cuda") * 1e-3).to(
        p.dtype) for n, p in model.named_parameters()}
    P = len(cfg.pattern)
    res = init_residuals(model, ccfg, P)
    del model
    torch.cuda.empty_cache()

    def fn():
        compress_decompress(grads, res, ccfg, P)

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        fn()
    end.record()
    torch.cuda.synchronize()
    host = start.elapsed_time(end) / 5
    ev = _device_events(fn, 2)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    digest = _digest(list(grads.values()) +
                     [r for r in res.values() if r is not None])
    n_comp = sum(r is not None for r in res.values())
    print(f"{tag:8s} compression per step ({n_comp} of {len(res)} leaves): "
          f"{host:9.3f} ms with the host, "
          f"{sum(d for _, d in ev) / 2 / 1e3:9.3f} ms on the device, "
          f"{len(ev) / 2:.0f} device kernels, peak {peak / 2**30:.3f} GiB "
          f"above the inputs, digest {digest}", flush=True)
    del grads, res
    torch.cuda.empty_cache()


def train(tag: str) -> None:
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_profile
    from repro_torch.configs import full_config
    from repro_torch.data import host_batch
    from repro_torch.launch.train import train_configs
    from repro_torch.train import init_train_state, make_train_step

    cfg = full_config(ARCH)
    ocfg, ccfg, dcfg, _ = train_configs(cfg, arch=ARCH, steps=8)
    state = init_train_state(cfg, ocfg, ccfg, seed=0, device="cuda")
    step_fn = make_train_step(cfg, ocfg, ccfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, res = [], None
    for step in range(7):
        batch = {k: torch.from_numpy(v).to("cuda")
                 for k, v in host_batch(dcfg, step).items()}
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) if step == 1 \
            else None
        if prof is not None:
            prof.__enter__()
        t = time.perf_counter()
        state, m = step_fn(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if prof is not None:
            prof.__exit__(None, None, None)
            res = device_profile(prof, dt * 1e6, ("quantize",))
            n_dev = len([e for e in prof.events()
                         if e.device_type.name == "CUDA"])
            del prof
            gc.collect()
        times.append(dt)
        assert loss == loss, f"step {step}: loss {loss}"
    ms = 1e3 * sum(times[2:]) / len(times[2:])
    quant = sum(v["calls"] * v["device_ms_per_call"]
                for v in res["kernels"].values())
    print(f"{tag:8s} train step: {ms:9.1f} ms, "
          f"{8 * 128 / ms * 1e3:8.0f} tokens/s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; step 1 "
          f"device busy {res['device_busy_ms']:.1f} ms "
          f"({100 * (res['device_busy_share'] or 0):.1f}%), {n_dev} device "
          f"kernels, quantize kernels {quant:.3f} ms; last loss {loss:.4f}",
          flush=True)
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()


def compare(root: Path, tag: str) -> None:
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import cuda as C
    from repro_torch.optim import compress  # noqa: F401

    # after ROOT's package is loaded: chip_smoke puts this tree's src first
    sys.path.insert(0, str(HERE))
    t0 = time.perf_counter()
    C.build()
    C.lib()
    print(f"{tag:8s} {root}: build {time.perf_counter() - t0:.1f} s",
          flush=True)
    b5_per_step(tag)
    compression(tag)
    train(tag)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ef_bench.py: no CUDA device")
    if sys.argv[1:] == ["sass"]:
        sass()
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) == 4:
        compare(Path(sys.argv[2]).resolve(), sys.argv[3])
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
