"""Build, load and count the port's hand-written CUDA kernels.

``csrc/f2p_kernels.cu`` is compiled at first use with ``nvcc`` into a shared
library with a plain C interface (``-gencode arch=compute_90a,code=sm_90a``,
no ``--use_fast_math``: the codec must stay bitwise; its parts by one nvcc
each, at once, then linked) and loaded with ``ctypes``. The library lands in ``repro_torch/_build/<source hash>/``, so an
edited source rebuilds and an unchanged one loads in milliseconds. Nothing
here runs at import time: the CPU tests import every module of the package
on a machine without ``nvcc``.

``LAUNCHES`` counts kernel launches per wrapper: each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels. No build or launch error is caught: a
failure raises where it happens.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "f2p_kernels.cu"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_PARTS = 4   # the source's F2P_PART values, compiled side by side

MAX_SMEM = 232448   # bytes of shared memory one CTA may use on Hopper

LAUNCHES: dict[str, int] = {"quantize_packed": 0, "kv_write": 0,
                            "dequantize_packed": 0, "kv_read": 0,
                            "quantize": 0, "ef_roundtrip": 0,
                            "dequantize": 0,
                            "attention_packed": 0, "attention_paged": 0,
                            "counter_advance": 0, "counter_estimate": 0,
                            "dequant_matmul": 0, "dequant_matmul_packed": 0}

_lib = None
build_log = ""       # nvcc's output (register / shared-memory report)
build_seconds = 0.0  # 0.0 when the library was already built


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class F2PConsts(ctypes.Structure):
    """Mirror of ``struct F2PConsts`` in the CUDA source."""
    _fields_ = [(n, ctypes.c_int) for n in
                ("nu", "h", "sgn", "vmax", "v_sub", "v_top", "bias",
                 "is_signed", "n_bits")]


class AttnLen(ctypes.Structure):
    """Mirror of ``struct AttnLen``: a per-row int32 / int64 tensor read at
    ``b * stride`` (stride 0: one value for every row), or ``value`` when
    ``p`` is null."""
    _fields_ = [("p", ctypes.c_void_p), ("stride", ctypes.c_longlong),
                ("is64", ctypes.c_int), ("value", ctypes.c_int)]


class KVSideIn(ctypes.Structure):
    """Mirror of ``struct KVSideIn``: one input of the KV write, x ``[B, S,
    Kh, cols]`` at strides (elements), and its destination words / scales."""
    _fields_ = [("x", ctypes.c_void_p)] + [
        (n, ctypes.c_longlong) for n in ("sb", "ss", "sh", "sd")] + [
        ("words", ctypes.c_void_p), ("scales", ctypes.c_void_p),
        ("W", ctypes.c_int), ("f", F2PConsts), ("inv_max", ctypes.c_float)]


def len_arg(v, B: int, default: int, dev):
    """A per-row length or position as the kernels read it: a Python int
    (or None: ``default``) by value, a tensor of one or B values in place
    (int32 / int64; other dtypes cast), with no copy and no sync. Returns
    (AttnLen, the tensor to keep alive)."""
    if v is None or isinstance(v, (int, np.integer)):
        x = default if v is None else int(v)
        return AttnLen(None, 0, 0, max(-2 ** 31, min(x, 2 ** 31 - 1))), None
    t = v
    if not (isinstance(v, torch.Tensor) and v.device == torch.device(dev)
            and v.dtype in (torch.int32, torch.int64)):
        t = torch.as_tensor(v, device=dev)
        if t.dtype not in (torch.int32, torch.int64):
            t = t.to(torch.int32)
    if t.ndim > 1 or t.numel() not in (1, B):
        raise ValueError(f"a length or position must be a scalar or [B={B}], "
                         f"got {tuple(t.shape)}")
    return AttnLen(t.data_ptr(), t.stride(0) if t.numel() > 1 else 0,
                   int(t.dtype == torch.int64), 0), t


_WS: dict = {}


def workspace(dev, stream: int, n_part: int, groups: int):
    """The split workspace of the kernels that merge partials in their last
    CTA (the matmul's decode route, attention) on (device, stream): room
    for ``n_part`` f32 partials and ``groups`` int32 counts, grown on
    demand. The counts start at zero and every launch leaves them at zero;
    launches on one stream are ordered, so one workspace serves them
    all."""
    ws = _WS.get((dev.index, stream))
    if ws is None or ws[0].numel() < n_part or ws[1].numel() < groups:
        n_part = max(n_part, 0 if ws is None else ws[0].numel())
        groups = max(groups, 0 if ws is None else ws[1].numel())
        ws = _WS[(dev.index, stream)] = (
            torch.empty(n_part, dtype=torch.float32, device=dev),
            torch.zeros(groups, dtype=torch.int32, device=dev))
    return ws


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def build() -> Path:
    """Compile the source if its hash has no library yet; return the path.
    The source's parts (its ``F2P_PART`` 1..``BUILD_PARTS``: the matmul's
    two routes, attention, the rest) compile side by side, one nvcc each,
    and link into one library."""
    global build_log, build_seconds
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                         + f" parts {BUILD_PARTS}".encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / key
    lib_path = out_dir / "libf2p_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(dir=out_dir))
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [work / f"part{p}.o" for p in range(1, BUILD_PARTS + 1)]
    procs = [subprocess.Popen(
        [_nvcc(), *compile_flags, f"-DF2P_PART={p}", "-c", "-o", str(o),
         str(SOURCE)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for p, o in enumerate(objs, 1)]
    logs = [proc.communicate()[0] for proc in procs]
    build_log = "".join(logs)
    failed = [p for p, proc in enumerate(procs, 1) if proc.returncode]
    if not failed:
        link = subprocess.run([_nvcc(), "-shared", "-o", str(work / "lib.so"),
                               *map(str, objs)], capture_output=True,
                              text=True)
        build_log += link.stdout + link.stderr
        failed = [f"link ({link.returncode})"] if link.returncode else []
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc failed (parts {failed}):\n{build_log}")
    os.replace(work / "lib.so", lib_path)   # atomic: concurrent builds agree
    shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return lib_path


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(str(build()))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        L.f2p_error_string.argtypes = [I]
        L.f2p_error_string.restype = ctypes.c_char_p
        L.f2p_kv_write.argtypes = [KVSideIn, KVSideIn, I, I, P, AttnLen] + [
            I] * 9 + [P]
        L.f2p_dequantize_packed.argtypes = [P, P, P, F2PConsts] * 2 + [
            I] * 5 + [P]
        LL, U = ctypes.c_longlong, ctypes.c_uint32
        L.f2p_quantize.argtypes = [P, I, P, I, P, LL, I, I, F2PConsts, P, F,
                                   I, P]
        L.f2p_ef_roundtrip.argtypes = [P, I, I, I, P, F2PConsts, F, P]
        L.f2p_encode_check.argtypes = [ctypes.c_uint, LL, P, F2PConsts, F, P,
                                       P, P]
        L.f2p_dequantize.argtypes = [P, I, P, P, I, LL, I, F2PConsts, P]
        L.f2p_attention.argtypes = [P, I, LL, LL, LL] + [P] * 5 + [
            AttnLen, AttnLen, P, P, P] + [I] * 16 + [F2PConsts, F2PConsts,
                                                    F, P]
        L.f2p_counter_advance.argtypes = [P] * 7 + [LL, I, U, U, I, LL, P]
        L.f2p_counter_estimate.argtypes = [P, P, P, LL, P]
        L.f2p_dequant_matmul.argtypes = [P, I, P, I, I, P, P, P] + [I] * 9 + [
            F2PConsts, P]
        L.f2p_dequant_matmul_decode.argtypes = [P, I, P, I, I, P, P, P, P] + [
            I] * 6 + [F2PConsts, P]
        for fn in (L.f2p_kv_write, L.f2p_dequantize_packed,
                   L.f2p_quantize, L.f2p_ef_roundtrip, L.f2p_encode_check,
                   L.f2p_dequantize, L.f2p_attention,
                   L.f2p_counter_advance, L.f2p_counter_estimate,
                   L.f2p_dequant_matmul, L.f2p_dequant_matmul_decode):
            fn.restype = I
        _lib = L
    return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        msg = lib().f2p_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")


def stream() -> int:
    """The current device's current stream, as the raw handle (the cheap
    query: the kernels launch on it from ctypes)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def require_cuda(t: torch.Tensor, what: str, dtype=None) -> None:
    """Wrapper-side argument check: the kernels take contiguous CUDA
    tensors of the stated dtype and nothing else. A DTensor (the sharded
    paths' state) has no storage of its own to hand a kernel: its caller
    passes the local shard (``.to_local()``) where the op is local."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        raise TypeError(f"{what} is a DTensor: a kernel takes its local "
                        "shard (.to_local()) where the op is local")
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
