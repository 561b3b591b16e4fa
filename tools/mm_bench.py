#!/usr/bin/env python3
"""Times one tree's dequant matmul (B7/B8) on its tile route at
llama3.2-3b's widths, so that two trees can be set beside each other in
one run on the card. Needs an NVIDIA GPU and the CUDA toolkit.

    python3 tools/mm_bench.py sass              # this tree's matmul build report
    python3 tools/mm_bench.py compare ROOT TAG  # one tree's timings
    python3 tools/mm_bench.py ablate            # the tensor-core kernel, parts left out

ROOT is the root of a checkout (this one, or an older one unpacked with
``git archive`` into a git-ignored directory); its ``src/repro_torch`` is
the code under test and builds its own kernels. Run the trees in the
order A, B, B, A in one call: the host's noise then shows as the spread
between a tree's two runs.

``sass``: nvcc's register and spill lines for the matmul kernels
(``dequant_matmul``) of this tree's source, from a build of its own.

``ablate``: builds this tree's kernel source (in parallel, into
``src/repro_torch/_build/ablate/``) once whole and once with one part of
the tensor-core kernel's K step left out: the x tile's copy into the ring
(after the first stages), the codes' copy, or the decode of the codes into
the W tile. A build with a part left out gives wrong results and serves
only to time what that part costs: B8 (``f2p_sr_2_8s`` uint8 codes) at
(3072, 8192), M = 2048, with f32 and with bf16 x, ms per call with the host
(CUDA events around 10 calls, the median of 3 runs).

``compare``, each line tagged: B8 (``f2p_sr_2_8s`` uint8 codes) and B7
(``f2p_sr_2_6s`` packed words), weights randn x 0.02 (torch.Generator seed
3) quantized by the tree's ``quantize_weight``, x randn (seed 5), at M =
2048 with f32 and bf16 x over the five projection shapes (K, N) in (3072,
3072), (3072, 1024), (3072, 8192), (8192, 3072), (3072, 128256), and at M
= 16 and 128 with f32 x at (3072, 8192): ms per call with the host (CUDA
events around 5 calls, the median of 3 runs) and on the device
(torch.profiler, all kernels of a call), the kernel that served the call
where the tree reports it, and the largest difference from the tree's own
plain version (held within rtol 1e-4, atol 1e-4 x max|y_plain|).
"""
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SHAPES = ((3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072),
          (3072, 128256))


def sass() -> None:
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.kernels import cuda as C

    out = C.BUILD_ROOT / "sass"     # a build of its own: the log is nvcc's
    out.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([C._nvcc(), *C.NVCC_FLAGS, "-o", str(out / "lib.so"),
                           str(C.SOURCE)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed\n{proc.stdout}{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "dequant_matmul" in line:
            for ln in lines[i:i + 4]:
                if "Compiling" in ln or "registers" in ln or "spill" in ln:
                    print("ptxas  :", ln.strip(), flush=True)


# part left out -> (text of csrc/f2p_kernels.cu, its replacement)
ABLATIONS = {
    "whole": [],
    "no x copy": [("      mma_copy16<kXE>(st + r * kMmaXPitch * kXE",
                   "      if (step < kS - 1) mma_copy16<kXE>(st + r * kMmaXPitch * kXE")],
    "no code copy": [("      mma_copy16<WSrc::kElem>(cs + r * c_pitch",
                      "      if (step < kS - 1) mma_copy16<WSrc::kElem>(cs + r * c_pitch")],
    "no decode": [("        decode(step + 1, h * kPer / kMmaK16, (h + 1) * kPer / kMmaK16);\n",
                   "")],
}


def ablate() -> None:
    sys.path.insert(0, str(HERE / "src"))
    sys.path.insert(0, str(HERE))
    import torch

    from chip_smoke import cuda_ms
    from repro_torch.core.formats import named_format
    from repro_torch.kernels import cuda as C
    from repro_torch.kernels import f2p_matmul as MM

    src = C.SOURCE.read_text()
    out = C.BUILD_ROOT / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            assert text.count(old) == 1, f"{name}: the kernel source changed"
            text = text.replace(old, new)
        stem = out / name.replace(" ", "_")
        stem.with_suffix(".cu").write_text(text)
        procs[name] = (subprocess.Popen(
            [C._nvcc(), *C.NVCC_FLAGS, "-o", str(stem.with_suffix(".so")),
             str(stem.with_suffix(".cu"))], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), stem.with_suffix(".so"))
    for name, (proc, _) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
    torch.backends.cuda.matmul.allow_tf32 = False
    fmt = named_format("f2p_sr_2_8s")
    g = torch.Generator(device="cuda").manual_seed(3)
    g5 = torch.Generator(device="cuda").manual_seed(5)
    w = torch.randn(3072, 8192, generator=g, device="cuda") * 0.02
    q, scales = MM.quantize_weight(w, fmt)
    xs = {dt: torch.randn(2048, 3072, generator=g5, device="cuda").to(
        getattr(torch, dt)) for dt in ("float32", "bfloat16")}
    for name, (_, so) in procs.items():
        C.build = lambda so=so: so      # this process loads this build
        C._lib = None
        C.lib()
        for dt, x in xs.items():
            def call():
                return MM.dequant_matmul(x, q, scales, fmt=fmt)

            ms = statistics.median(cuda_ms(call, iters=10) for _ in range(3))
            print(f"ablate   {name:13s} B8 M=2048 {dt:8s} K=3072 N=8192: "
                  f"{ms:.5f} ms", flush=True)


def cases():
    """(K, N, M, x dtype name) of the compare run."""
    out = [(K, N, 2048, dt) for K, N in SHAPES
           for dt in ("float32", "bfloat16")]
    return out + [(3072, 8192, 16, "float32"), (3072, 8192, 128, "float32")]


def compare(root: Path, tag: str) -> None:
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.core.formats import named_format
    from repro_torch.kernels import cuda as C
    from repro_torch.kernels import f2p_matmul as MM

    # after ROOT's package is loaded: chip_smoke puts this tree's src first
    sys.path.insert(0, str(HERE))
    from chip_smoke import cuda_ms, device_ms, plain_matmul

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    C.build()
    C.lib()
    print(f"{tag:8s} {root}: build {time.perf_counter() - t0:.1f} s",
          flush=True)
    served = getattr(MM, "SERVED", None)
    kinds = (("B8", named_format("f2p_sr_2_8s"), False),
             ("B7", named_format("f2p_sr_2_6s"), True))
    g = torch.Generator(device="cuda").manual_seed(3)
    g5 = torch.Generator(device="cuda").manual_seed(5)
    weights = {}
    for K, N, M, dt in cases():
        if (K, N) not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            w = torch.randn(K, N, generator=g, device="cuda") * 0.02
            weights[(K, N)] = {name: MM.quantize_weight(w, fmt, packed=packed)
                               for name, fmt, packed in kinds}
            del w
        x = torch.randn(M, K, generator=g5, device="cuda").to(
            getattr(torch, dt))
        for name, fmt, packed in kinds:
            q, scales = weights[(K, N)][name]

            def call():
                return MM.dequant_matmul(x, q, scales, fmt=fmt, packed=packed)

            before = dict(served) if served is not None else None
            y = call()
            kernel = ("-" if served is None else
                      next(k for k in served if served[k] != before[k]))
            ref = plain_matmul(x, q, scales, fmt, packed)
            torch.cuda.synchronize()
            torch.testing.assert_close(y, ref, rtol=1e-4,
                                       atol=1e-4 * float(ref.abs().max()))
            err = float((y - ref).abs().max())
            del y, ref
            ms = statistics.median(cuda_ms(call, iters=5) for _ in range(3))
            dms = device_ms(call, iters=10)
            print(f"{tag:8s} {name} M={M:4d} {dt:8s} K={K} N={N:6d} "
                  f"{kernel:5s}: {ms:.5f} ms, device "
                  f"{'not measured' if dms is None else f'{dms:.5f}'}, "
                  f"max |err| {err:.2e}", flush=True)
        del x


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("mm_bench.py: no CUDA device")
    if sys.argv[1:] == ["sass"]:
        sass()
    elif sys.argv[1:] == ["ablate"]:
        ablate()
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) == 4:
        compare(Path(sys.argv[2]).resolve(), sys.argv[3])
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
