#!/usr/bin/env python3
"""B4 (the packed-F2P dequantize) on the card: variants of its kernel side
by side, and what one K+V read costs on the host, piece by piece. Needs an
NVIDIA GPU and the CUDA toolkit.

    python3 tools/dq_bench.py variants   # ~3 min: five nvcc builds in parallel
    python3 tools/dq_bench.py host       # ~1 min

``variants`` writes text substitutions of ``csrc/f2p_kernels.cu`` into the
git-ignored ``chip_tmp/dq_variants/``, builds them with one nvcc each, all
started together, prints each B4 instance's registers and spills, then
times each library in three rounds (in turns, so that a drift of the card
shows as the spread of a variant's rounds): the device time per call of
``dequantize_packed_kernel`` (torch.profiler), L2 warm and cold (a 64 MB
write before each launch), in the single mode on one layer's K words
[8192, 32] and in the K+V mode on the layer (layer 1 of 2 x [1, 1024, 8,
128], ``f2p_sr_2_8s``, bf16 out; chip_smoke phase 3's shape). The
variants: the source as it is; 3 or 4 CTAs per SM (the launch bounds and
the grid); the grid of 4 per SM with the source's launch bounds; an empty
kernel (the floor of a launch); the table build and its barrier left out
(values wrong, timing only); every width decoded in registers. The first
two and the last are held bitwise to the plain version.

``host`` times, on the host's clock over 3000 calls each, the pieces of
``f2p_kv_read`` at the same shape (the shape check, the two output
allocations, the dtype / device / contiguity checks, the ctypes call with
0 rows and with a launch), the whole call, the single mode, and the two
``QTensor.dequantize`` calls that ``_cache_read`` made before the K+V
mode; and, for scale, one small torch kernel launch (``zero_``).
"""
import concurrent.futures as cf
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SUBS = {
    "source": [],
    "per_sm3": [("constexpr int kDQPerSM = 2;", "constexpr int kDQPerSM = 3;")],
    "per_sm4": [("constexpr int kDQPerSM = 2;", "constexpr int kDQPerSM = 4;")],
    "grid4": [("kDQPerSM * sm_count() / nside", "4 * sm_count() / nside")],
    "empty": [("  const DQSide& s = a.side[blockIdx.y];\n",
               "  if (a.n > 0) return;\n  const DQSide& s = a.side[blockIdx.y];\n")],
    "no_table_build": [("    attn_table(tab, s.tab_bits, s.f);\n    __syncthreads();\n",
                        "")],
    "registers": [("  s.tab_bits = nb <= 8 ? (s.f.is_signed ? s.f.nu : nb) : 0;",
                   "  s.tab_bits = 0;")],
}
EXACT = ("source", "per_sm3", "per_sm4", "grid4", "registers")


def _build(name: str, subs) -> tuple:
    from repro_torch.kernels import cuda as C

    src = C.SOURCE.read_text()
    for a, b in subs:
        if src.count(a) != 1:
            raise SystemExit(f"variant {name}: the source no longer holds "
                             f"{a!r}")
        src = src.replace(a, b)
    d = ROOT / "chip_tmp" / "dq_variants" / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "f2p_kernels.cu").write_text(src)
    lib = d / "libf2p_kernels.so"
    p = subprocess.run([C._nvcc(), *C.NVCC_FLAGS, "-o", str(lib),
                        str(d / "f2p_kernels.cu")], capture_output=True,
                       text=True)
    if p.returncode:
        raise SystemExit(f"variant {name}: nvcc failed\n{p.stderr[-3000:]}")
    lines = (p.stdout + p.stderr).splitlines()
    regs = []
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "dequantize_packed_kernel" in line:
            inst = line.split("'")[1]
            info = " ".join(x.split(":", 1)[-1].strip()
                            for x in lines[i + 1:i + 4])
            regs.append(f"{inst}: {info}")
    return name, lib, regs


def _inputs():
    import torch

    import chip_smoke as CS
    from repro_torch.core.formats import named_format

    g = torch.Generator(device="cuda").manual_seed(1)
    fmt = named_format("f2p_sr_2_8s")
    cache = CS.kv_read_cache("cuda", g, fmt)
    ck = cache["k"]
    return fmt, cache, ck.codes.reshape(8192, -1), ck.scales.reshape(8192, 1)


def variants() -> None:
    import torch

    import chip_smoke as CS
    from repro_torch.kernels import cuda as C
    from repro_torch.kernels import f2p_quant as Q

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(len(SUBS)) as ex:
        built = list(ex.map(lambda kv: _build(*kv), SUBS.items()))
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, _, regs in built:
        for r in regs:
            print(f"{name:15s} {r}", flush=True)
    fmt, cache, w, s = _inputs()
    bf = torch.bfloat16
    single = lambda: Q.f2p_dequantize_packed(w, s, fmt, out_dtype=bf)
    both = lambda: Q.f2p_kv_read(cache, bf)
    ref_single = Q.dequantize_packed_plain(w, s, fmt, 128, bf)
    ref_both = Q.kv_read_plain(cache, bf)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for rnd in range(3):
        for name, lib, _ in built:
            C._lib = None
            C.build = lambda lib=lib: lib
            C.lib()
            if name in EXACT:
                assert torch.equal(single(), ref_single), name
                assert all(torch.equal(a, b)
                           for a, b in zip(both(), ref_both)), name
            cols = []
            for fn in (single, both):
                warm, _ = CS.device_calls(fn, "dequantize_packed_kernel",
                                          iters=50)
                cold, _ = CS.device_calls(fn, "dequantize_packed_kernel",
                                          iters=50, flush=scratch.zero_)
                cols.append(f"{CS._ms(warm)} / cold {CS._ms(cold)}")
            print(f"round {rnd} {name:15s} single {cols[0]} ms; K+V "
                  f"{cols[1]} ms", flush=True)
    print(CS.smi_line())


def host() -> None:
    import torch

    import chip_smoke as CS
    from repro_torch.core import qtensor as QT
    from repro_torch.kernels import cuda as C
    from repro_torch.kernels import f2p_quant as Q

    fmt, cache, w, s = _inputs()
    ck, cv = cache["k"], cache["v"]
    kw, ks, vw, vs = ck.codes, ck.scales, cv.codes, cv.scales
    bf = torch.bfloat16
    shape = tuple(ck.logical_shape)
    L = C.lib()

    def t(name, fn, n=3000):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        print(f"host {name:48s} {dt:8.3f} us", flush=True)

    consts = Q.cuda_consts(fmt)
    k, v = (torch.empty(shape, dtype=bf, device="cuda") for _ in range(2))
    args = [kw.data_ptr(), ks.data_ptr(), k.data_ptr(), consts, vw.data_ptr(),
            vs.data_ptr(), v.data_ptr(), consts, 2, 1, 8192, 128, 128,
            C.stream()]
    tiny = torch.zeros(1, device="cuda")
    t("shape check (_kv_read_shape)", lambda: Q._kv_read_shape(ck, cv))
    t("two outputs (new_empty x 2)",
      lambda: (kw.new_empty(shape, dtype=bf), kw.new_empty(shape, dtype=bf)))
    t("dtype / device / contiguity checks", lambda: (
        kw.dtype == torch.uint32 and vw.dtype == torch.uint32
        and ks.dtype == torch.float32 and vs.dtype == torch.float32
        and vw.get_device() == kw.get_device()
        and ks.get_device() == kw.get_device()
        and vs.get_device() == kw.get_device() and kw.is_contiguous()
        and vw.is_contiguous() and ks.is_contiguous()
        and vs.is_contiguous()))
    t("C.stream()", C.stream)
    t("ctypes call, 0 rows (no launch)",
      lambda: L.f2p_dequantize_packed(*args[:10], 0, *args[11:]))
    t("ctypes call with its launch", lambda: L.f2p_dequantize_packed(*args))
    t("f2p_kv_read (K+V mode)", lambda: Q.f2p_kv_read(cache, bf))
    t("f2p_dequantize_packed (single mode)",
      lambda: Q.f2p_dequantize_packed(w, s, fmt, out_dtype=bf))
    t("two QTensor.dequantize (the old _cache_read)",
      lambda: (QT.dequantize(ck, dtype=bf), QT.dequantize(cv, dtype=bf)))
    t("one small torch kernel (zero_)", tiny.zero_)
    print(CS.smi_line())


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("dq_bench.py: no CUDA device")
    if sys.argv[1:] == ["variants"]:
        variants()
    elif sys.argv[1:] == ["host"]:
        host()
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
