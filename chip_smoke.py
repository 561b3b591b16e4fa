#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check raises, so the script exits non-zero):

1. device  — card name and power limit (nvidia-smi), library versions.
2. build   — nvcc builds csrc/f2p_kernels.cu from the checkout (sm_90a).
3. kernels — each hand-written kernel at the serve path's shapes against
   its plain PyTorch version ON THE CARD: the codec bitwise (words, scales,
   values; 6/8/16-bit formats, f32 and bf16), attention within
   rtol=atol=1e-5 in f32 plus paged == dense-over-gathered-pages bitwise.
   Each is timed with CUDA events after a warm-up, beside its bound (bytes
   this call must move / 3.35 TB/s, the H100 SXM HBM3 rate), its plain
   version and, for attention, torch's scaled_dot_product_attention on K/V
   dequantized up front (a yardstick the port never calls).
4. small   — smoke llama3.2-3b in f32 on the card (kernels) against the
   same weights on the CPU (plain versions): logits agree within 1e-3.
5. serve   — full-width llama3.2-3b (28 layers, d_model 3072, bf16, random
   weights from torch.Generator seed 0): 16 staggered requests through
   BatchedEngine(slots=8, max_seq=1024), paged, then copy-in; every request
   finishes and both modes give bitwise-equal tokens. Then a short
   Engine(fused_attention=False) run (the dequantize path) and a sequential
   Engine replay whose token agreement is printed, not asserted (cuBLAS may
   sum batch-1 and batch-8 products in different orders at bf16). Every
   kernel's launch counter is zeroed just before the path that runs it and
   read just after; each must be > 0.
6. profile — torch.profiler over a short paged run: the device's busy
   share of the wall time and each kernel's device time per call (the
   phase-3 times include the Python wrapper; these do not).

Prints one ``{"kernels": [...]}`` JSON line, then the nvidia-smi line, then
the last line ``{"ok": true, "device": {...}}``. A copy of the results
goes to chiprun_out/chip_smoke.json.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
SRC = "src/repro_torch/csrc/f2p_kernels.cu"
REPLACES = {
    "quantize_packed": "src/repro/kernels/f2p_quant.py:341",
    "dequantize_packed": "src/repro/kernels/f2p_quant.py:352",
    "attention_packed": "src/repro/kernels/f2p_attention.py:183",
    "attention_paged": "src/repro/kernels/f2p_attention.py:385",
}


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=30, warm=3) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions on the card
# ---------------------------------------------------------------------------
def check_codec(dev):
    import torch

    from repro_torch.core.formats import named_format
    from repro_torch.kernels import f2p_quant as Q

    g = torch.Generator(device=dev).manual_seed(1)
    out = {}
    # decode: slots 8 x 8 kv heads rows of head_dim 128; prefill: a
    # group of 4 prompts at bucket 256 x 8 kv heads
    for name in ("f2p_sr_2_6s", "f2p_sr_2_8s", "f2p_lr_2_16s"):
        fmt = named_format(name)
        for rows, dt in ((64, torch.bfloat16), (64, torch.float32),
                         (8192, torch.bfloat16)):
            x = (torch.randn(rows, 128, generator=g, device=dev) * 3).to(dt)
            x[0, :32] = 0
            x[1] = 0
            w, s = Q.f2p_quantize_packed(x, fmt)
            pw, ps = Q.quantize_packed_plain(x, fmt, 128)
            assert torch.equal(w.view(torch.int32), pw.view(torch.int32)), \
                f"quantize words differ: {name} {rows} {dt}"
            assert torch.equal(s, ps), f"quantize scales differ: {name}"
            for odt in (torch.float32, torch.bfloat16):
                d = Q.f2p_dequantize_packed(w, s, fmt, out_dtype=odt)
                pd = Q.dequantize_packed_plain(w, s, fmt, 128, odt)
                assert torch.equal(d, pd), f"dequantize differs: {name} {odt}"
    log("codec    : quantize/dequantize kernels == plain, bitwise "
        "(6/8/16-bit, f32+bf16 in, f32+bf16 out)")
    fmt = named_format("f2p_sr_2_8s")
    W = 32
    # quantize at the decode shape (every layer, every step, k and v)
    x = torch.randn(64, 128, generator=g, device=dev).to(torch.bfloat16)
    nb = 64 * 128 * 2 + 64 * W * 4 + 64 * 4
    got = Q.dequantize_packed_plain(*Q.f2p_quantize_packed(x, fmt), fmt, 128)
    ref = Q.dequantize_packed_plain(*Q.quantize_packed_plain(x, fmt, 128),
                                    fmt, 128)
    out["quantize_packed"] = dict(
        ms=cuda_ms(lambda: Q.f2p_quantize_packed(x, fmt), iters=200),
        plain_ms=cuda_ms(lambda: Q.quantize_packed_plain(x, fmt, 128)),
        bound_ms=bound_ms(nb), library_ms=None,
        max_abs_err=float((got - ref).abs().max()),
        shape="x [64, 128] bf16 -> words [64, 32], scales [64, 1]")
    xp = torch.randn(8192, 128, generator=g, device=dev).to(torch.bfloat16)
    log(f"quantize : decode [64,128] {out['quantize_packed']['ms']:.5f} ms; "
        f"prefill [8192,128] "
        f"{cuda_ms(lambda: Q.f2p_quantize_packed(xp, fmt)):.5f} ms "
        f"(bound {bound_ms(8192 * (256 + 128 + 4)):.5f} ms)")
    # dequantize at the Engine(fused_attention=False) cache read: the
    # whole [1, 1024, 8] cache of one layer, bf16 out
    rows = 1024 * 8
    w, s = Q.f2p_quantize_packed(
        torch.randn(rows, 128, generator=g, device=dev), fmt)
    nb = rows * W * 4 + rows * 4 + rows * 128 * 2
    d = Q.f2p_dequantize_packed(w, s, fmt, out_dtype=torch.bfloat16)
    pd = Q.dequantize_packed_plain(w, s, fmt, 128, torch.bfloat16)
    out["dequantize_packed"] = dict(
        ms=cuda_ms(lambda: Q.f2p_dequantize_packed(
            w, s, fmt, out_dtype=torch.bfloat16), iters=100),
        plain_ms=cuda_ms(lambda: Q.dequantize_packed_plain(
            w, s, fmt, 128, torch.bfloat16)),
        bound_ms=bound_ms(nb), library_ms=None,
        max_abs_err=float((d.float() - pd.float()).abs().max()),
        shape="words [8192, 32] + scales -> [8192, 128] bf16")
    return out


def check_attention(dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.core import qtensor as QT
    from repro_torch.core.formats import named_format
    from repro_torch.kernels import f2p_attention as A

    g = torch.Generator(device=dev).manual_seed(2)
    fmt = named_format("f2p_sr_2_8s")
    B, K, G, hd, T, S = 8, 8, 3, 128, 8, 1024
    maxp = S // T
    P = (B + 1) * maxp + 1
    kv_len = torch.randint(512, S + 1, (B,), generator=g, device=dev)
    q = torch.randn(B, 1, K * G, hd, generator=g, device=dev)
    slab_k = QT.quantize(torch.randn(P, T, K, hd, generator=g, device=dev),
                         fmt, block=hd)
    slab_v = QT.quantize(torch.randn(P, T, K, hd, generator=g, device=dev),
                         fmt, block=hd)
    perm = torch.randperm(P, generator=g, device=dev)
    pages = perm[:B * maxp].reshape(B, maxp).to(torch.int32)
    dense_k = A.gather_pages_to_dense(slab_k, pages)
    dense_v = A.gather_pages_to_dense(slab_v, pages)
    out = {}
    paged = A.attention_paged(q, slab_k, slab_v, pages, kv_len=kv_len)
    dense = A.attention_packed(q, dense_k, dense_v, kv_len=kv_len)
    assert torch.equal(paged, dense), \
        "paged != dense-over-gathered-pages on the card"
    # causal multi-query through both addressing modes
    qm = torch.randn(B, 4, K * G, hd, generator=g, device=dev)
    cm = dict(kv_len=kv_len, causal=True, q_offset=kv_len - 4)
    pm = A.attention_paged(qm, slab_k, slab_v, pages, **cm)
    assert torch.equal(pm, A.attention_packed(qm, dense_k, dense_v, **cm))
    torch.testing.assert_close(pm, A.attention_paged_plain(
        qm, slab_k, slab_v, pages, **cm), rtol=1e-5, atol=1e-5)

    # bytes this call needs: live K/V words + scales of every (row, head),
    # q in, out, the live page ids and the lens
    live = int(kv_len.sum())
    nb = live * K * 2 * (32 * 4 + 4) + 2 * B * K * G * hd * 4 \
        + int(((kv_len + T - 1) // T).sum()) * 4 + B * 8
    # yardstick: SDPA over K/V dequantized up front (f32, GQA expanded)
    kd = dense_k.dequantize().repeat_interleave(G, dim=2).transpose(1, 2)
    vd = dense_v.dequantize().repeat_interleave(G, dim=2).transpose(1, 2)
    mask = (torch.arange(S, device=dev)[None, :] < kv_len[:, None])
    mask = mask[:, None, None, :]
    qs = q.transpose(1, 2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, kd, vd, attn_mask=mask))
    for name, fn, plain, got in (
            ("attention_paged",
             lambda: A.attention_paged(q, slab_k, slab_v, pages,
                                       kv_len=kv_len),
             lambda: A.attention_paged_plain(q, slab_k, slab_v, pages,
                                             kv_len=kv_len), paged),
            ("attention_packed",
             lambda: A.attention_packed(q, dense_k, dense_v, kv_len=kv_len),
             lambda: A.attention_packed_plain(q, dense_k, dense_v,
                                              kv_len=kv_len), dense)):
        ref = plain()
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        out[name] = dict(
            ms=cuda_ms(fn, iters=100), plain_ms=cuda_ms(plain, iters=10),
            bound_ms=bound_ms(nb), library_ms=lib_ms,
            max_abs_err=float((got - ref).abs().max()),
            shape=f"B={B} K={K} R={G} hd={hd} span {S} kv_len 512..{S} "
                  f"(live {live}) tile 128 page {T}")
    log("attention: paged == dense-over-gathered bitwise; both within "
        "1e-5 of the plain version (decode and causal multi-query)")
    return out


# ---------------------------------------------------------------------------
# phase 4: small model, card vs CPU
# ---------------------------------------------------------------------------
def check_small(dev):
    import dataclasses

    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.models import (decode_step, init_caches, init_params,
                                    prefill)
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(smoke_config("llama3_2_3b"),
                              fused_attention=True)
    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = Model(cfg, dev)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 13),
                         generator=torch.Generator().manual_seed(3))
    caches = {d: init_caches(cfg, 2, 64, quantized_kv=True, device=d)
              for d in ("cpu", dev)}
    lc = prefill(cpu, toks, caches["cpu"])
    lg = prefill(gpu, toks.to(dev), caches[dev])
    worst = float((lg.cpu() - lc).abs().max())
    for i in range(6):
        tok = torch.argmax(lc, -1)[:, None]
        lc = decode_step(cpu, tok, 13 + i, caches["cpu"])
        lg = decode_step(gpu, tok.to(dev), 13 + i, caches[dev])
        worst = max(worst, float((lg.cpu() - lc).abs().max()))
    assert worst < 1e-3, f"card vs CPU logits differ by {worst}"
    log(f"small    : smoke llama (f32) card vs CPU logits max |diff| "
        f"{worst:.3e} over prefill + 6 decode steps")


# ---------------------------------------------------------------------------
# phase 5: full-width serving
# ---------------------------------------------------------------------------
def serve(dev, launches):
    import numpy as np
    import torch

    from repro_torch.configs import full_config
    from repro_torch.kernels import cuda as C
    from repro_torch.models import init_params
    from repro_torch.serve import (BatchedEngine, BatchedServeConfig, Engine,
                                   Request, ServeConfig)

    cfg = full_config("llama3_2_3b")
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"serve    : {cfg.name} {cfg.n_layers}L d={cfg.d_model} "
        f"H={cfg.n_heads}/{cfg.n_kv_heads} ff={cfg.d_ff} V={cfg.vocab_size} "
        f"{cfg.dtype}, {cfg.param_count() / 1e9:.2f}B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=u + 1,
                    tokens=rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(16, 257))
                                        ).astype(np.int32),
                    max_new=32, arrival=4 * u) for u in range(16)]
    bs = dict(slots=8, max_seq=1024)

    def run(tag, **kw):
        eng = BatchedEngine(cfg, BatchedServeConfig(**bs, **kw), model)
        C.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = eng.run(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = dict(C.LAUNCHES)
        ntok = sum(len(v) for v in out.values())
        assert sorted(out) == [r.uid for r in reqs], f"{tag}: lost requests"
        for r in reqs:
            o = out[r.uid]
            assert len(o) == r.max_new, f"{tag}: request {r.uid} short"
            assert ((o >= 0) & (o < cfg.vocab_size)).all()
        st = eng.stats
        log(f"serve    : {tag}: {len(out)} requests, {ntok} tokens in "
            f"{dt:.2f} s = {ntok / dt:.1f} tok/s (wall, prefill included); "
            f"{st['rounds']} rounds, {st.get('prefill_calls', 0)} prefill "
            f"calls, occupancy {st['slot_occupancy']:.2f}, pool peak "
            f"{st['pool']['peak_used']}/{st['pool']['n_pages']} pages; "
            f"launches {counts}")
        return out, counts, ntok / dt, st

    run("warm-up (paged)")
    paged, cnt_p, tps_p, st_p = run("paged")
    copy_in, cnt_c, tps_c, _ = run("copy-in", paged_decode=False)
    for r in reqs:
        assert np.array_equal(paged[r.uid], copy_in[r.uid]), \
            f"request {r.uid}: paged != copy-in"
    log("serve    : paged == copy-in, token for token, all 16 requests")
    launches["attention_paged"] = cnt_p["attention_paged"]
    launches["quantize_packed"] = cnt_p["quantize_packed"]
    launches["attention_packed"] = cnt_c["attention_packed"]

    eng = Engine(cfg, ServeConfig(batch=1, max_seq=1024, quantized_kv=True),
                 model)
    C.reset_launches()
    short = eng.generate(reqs[0].tokens[None], 4)
    torch.cuda.synchronize()
    launches["dequantize_packed"] = C.LAUNCHES["dequantize_packed"]
    log(f"serve    : Engine(fused_attention=False) 4 tokens, launches "
        f"{dict(C.LAUNCHES)}; first tokens agree with paged: "
        f"{np.array_equal(short[0], paged[reqs[0].uid][:4])}")

    seq = Engine(cfg, ServeConfig(batch=1, max_seq=1024, quantized_kv=True,
                                  fused_attention=True), model)
    agree = total = 0
    for r in reqs:
        o = seq.generate(r.tokens[None], r.max_new)[0]
        agree += int((o == paged[r.uid]).sum())
        total += r.max_new
    log(f"serve    : sequential Engine agreement {agree}/{total} tokens "
        "(printed, not asserted)")
    for name, n in launches.items():
        assert n > 0, f"kernel {name} never launched on its path"
    return dict(paged_tok_s=tps_p, copy_in_tok_s=tps_c,
                seq_agreement=f"{agree}/{total}", rounds=st_p["rounds"],
                profile=profile_decode(cfg, model, bs))


def profile_decode(cfg, model, bs) -> dict:
    """torch.profiler over a short paged run (8 requests of 64 tokens, 2
    prefill calls + 16 decode steps): the device's busy share of the wall
    time, each kernel's device time per call, and the top kernels."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import BatchedEngine, BatchedServeConfig, Request

    rng = np.random.default_rng(1)
    reqs = [Request(uid=u + 1, tokens=rng.integers(0, cfg.vocab_size, 64),
                    max_new=17) for u in range(8)]
    eng = BatchedEngine(cfg, BatchedServeConfig(**bs), model)
    eng.run(reqs)                       # same shapes, outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    dev = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, cur = 0.0, None
    for _, s, e in sorted(dev, key=lambda x: x[1]):
        if cur is None or s > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    per = {}
    for name, s, e in dev:
        n, tot = per.get(name, (0, 0.0))
        per[name] = (n + 1, tot + (e - s))
    top = sorted(per.items(), key=lambda kv: -kv[1][1])[:8]
    ours = {k: dict(calls=n, device_ms_per_call=tot / n / 1e3)
            for k, (n, tot) in per.items()
            if "attention_kernel" in k or "quantize_packed" in k}
    res = dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
               device_busy_share=busy / wall_us if dev else None,
               kernels=ours,
               top=[dict(name=k[:80], calls=n, device_ms=tot / 1e3)
                    for k, (n, tot) in top])
    if not dev:
        log("profile  : the profiler saw no device activity: not measured")
        return res
    log(f"profile  : 2 prefill calls + 16 decode steps, wall "
        f"{res['wall_ms']:.1f} ms, device busy {res['device_busy_ms']:.1f} ms "
        f"({100 * res['device_busy_share']:.1f}%)")
    for k, v in ours.items():
        log(f"profile  :   {k[:60]}: {v['calls']} calls, "
            f"{v['device_ms_per_call']:.5f} ms device per call")
    for t in res["top"]:
        log(f"profile  :   top {t['device_ms']:9.3f} ms {t['calls']:6d} x "
            f"{t['name']}")
    return res


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device — the port's kernels "
                         "run only on an NVIDIA GPU")
    from repro_torch.kernels import cuda as C

    dev = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"device   : {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    C.build()
    C.lib()
    log(f"build    : {time.perf_counter() - t0:.1f} s (nvcc "
        f"{C.build_seconds:.1f} s)")
    for line in C.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas  :", line.strip())

    res = check_codec(dev)
    res.update(check_attention(dev))
    check_small(dev)
    launches: dict[str, int] = {}
    serve_res = serve(dev, launches)

    kernels = []
    for name in ("attention_paged", "attention_packed", "quantize_packed",
                 "dequantize_packed"):
        r = res[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SRC,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": r["library_ms"]})
        log(f"kernel   : {name:18s} {r['ms']:.5f} ms (bound "
            f"{r['bound_ms']:.5f}, plain {r['plain_ms']:.5f}, library "
            f"{r['library_ms']}) launches {launches[name]} | {r['shape']}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": smi, "kernels": kernels, "serve": serve_res,
         "shapes": {k: v["shape"] for k, v in res.items()}}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
