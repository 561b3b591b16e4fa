"""Continuous-batching example on the PyTorch port (twin of
``examples/serve_continuous.py``): N staggered requests through the
block-paged packed-F2P KV pool, with optional observability capture.

Serves a queue of mixed-length requests arriving at different times through
:class:`repro_torch.serve.BatchedEngine` — dynamic admission into fixed
decode slots whose KV is attended THROUGH page tables over the packed pool
slabs — then replays every request through the copy-in engine
(``paged_decode=False``) and one at a time through the sequential
:class:`repro_torch.serve.Engine`, and asserts the greedy outputs are
bit-for-bit identical three ways. Reports aggregate tokens/s, plus the
pool's packed-vs-logical-f32 footprint. On the card the paged run attends
through B1 (``attention_decode_kernel``, paged), the copy-in and the
sequential runs through B2 (the same kernel over a dense cache), and every
KV write is one B3 launch per layer.

``--trace PATH`` arms the obs span tracer for the timed run and writes a
Chrome/Perfetto trace_event JSON, then validates it — JSON loads, every
request has its per-request spans, and the metrics registry agrees with
the engine's stats view — and fails on any mismatch.

    PYTHONPATH=src python examples/torch_serve_continuous.py \\
        [--trace out.trace.json] [--device cpu]

Differences from the reference, by design:

- the weights come from ``torch.Generator`` seed 0, so the tokens are the
  twin's own (:func:`serve_continuous` takes a ``model`` to serve the
  reference's); the request queue is the reference's (numpy seed 42);
- the sequential ``Engine`` has no ``packed_kv`` switch (the port's
  quantized caches are always packed).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch import obs, require_device
from repro_torch.configs import smoke_config
from repro_torch.models import init_params
from repro_torch.serve import (BatchedEngine, BatchedServeConfig, Engine,
                               Request, ServeConfig)


def make_requests(vocab: int, n_req: int = 12) -> list:
    """The reference's queue: numpy seed 42, staggered arrivals."""
    rng = np.random.default_rng(42)
    return [Request(uid=u + 1,
                    tokens=rng.integers(0, vocab, int(rng.integers(4, 25))
                                        ).astype(np.int32),
                    max_new=int(rng.integers(8, 25)),
                    arrival=3 * u)           # staggered arrivals
            for u in range(n_req)]


def validate_trace(path: str, reqs, eng) -> int:
    """The examples-smoke acceptance: the written trace must be loadable
    Chrome trace_event JSON with per-request ttft/decode spans for EVERY
    request, and the obs metrics must agree with the engine stats view.
    Returns the number of events."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    assert isinstance(events, list) and events, "empty trace"
    for ev in events:
        assert {"name", "ph", "pid", "tid"} <= set(ev), f"malformed: {ev}"
        if ev["ph"] in ("X", "i", "C"):
            assert "ts" in ev, f"timed event without ts: {ev}"
        if ev["ph"] == "X":
            assert ev["dur"] >= 0, f"negative duration: {ev}"
    by_req = {}
    for ev in events:
        if ev["ph"] == "X" and ev["name"] in ("ttft", "decode"):
            by_req.setdefault(ev["args"]["uid"], set()).add(ev["name"])
    for r in reqs:
        assert by_req.get(r.uid) == {"ttft", "decode"}, \
            f"request {r.uid}: missing per-request spans ({by_req.get(r.uid)})"
    names = {ev["name"] for ev in events}
    for want in ("round", "prefill", "admit", "retire"):
        assert want in names, f"engine timeline missing {want!r} events"
    # the registry's exact shadows ARE the engine.stats numbers, and the
    # TTFT histogram saw every request (the engine's own registry: the
    # copy-in engine registered one too)
    snap = eng.metrics.export()
    assert snap["counters"]["prefills"]["exact"] == eng.stats["prefills"]
    assert snap["histograms"]["ttft_ms"]["count"] == eng.stats["prefills"]
    assert snap["counters"]["emitted_tokens"]["exact"] == \
        eng.stats["emitted_tokens"]
    print(f"trace OK  : {len(events)} events, {len(by_req)} request rows "
          f"-> {path}")
    return len(events)


def _first_difference(reqs, got: dict, want: dict):
    """(uid, token index) of the first request whose tokens differ."""
    for r in reqs:
        a, b = got[r.uid], want[r.uid]
        if not np.array_equal(a, b):
            n = min(len(a), len(b))
            diff = np.nonzero(a[:n] != b[:n])[0]
            return r.uid, int(diff[0]) if diff.size else n
    return None


def serve_continuous(device, *, model=None, trace: str = "") -> dict:
    """Serve the queue paged, copy-in and sequentially; prints the
    reference's report and returns its numbers and every run's tokens."""
    cfg = smoke_config("llama3_2_3b")
    if model is None:
        model = init_params(cfg, seed=0, device=device)
    n_req, slots, max_seq = 12, 4, 64
    reqs = make_requests(cfg.vocab_size, n_req)

    eng = BatchedEngine(cfg, BatchedServeConfig(slots=slots,
                                                max_seq=max_seq), model)
    eng.run(reqs)                            # warm-up: first use outside clock
    if trace:
        obs.enable(trace=True)
    t0 = time.perf_counter()
    out = eng.run(reqs)
    dt_b = time.perf_counter() - t0
    if trace:
        obs.get().tracer.write_chrome(trace)
        obs.disable()
    ntok = sum(len(v) for v in out.values())

    # the copy-in engine (dense slot rows, pages gathered in) is the paged
    # path's bitwise reference — same queue, same schedule
    ceng = BatchedEngine(cfg, BatchedServeConfig(slots=slots, max_seq=max_seq,
                                                 paged_decode=False), model)
    cout = ceng.run(reqs)
    for r in reqs:
        assert np.array_equal(out[r.uid], cout[r.uid]), \
            f"request {r.uid}: paged output diverged from copy-in"

    seq = Engine(cfg, ServeConfig(batch=1, max_seq=max_seq,
                                  quantized_kv=True, fused_attention=True),
                 model)
    for r in reqs:                           # warm-up each prompt shape
        seq.generate(r.tokens[None], 2)
    t0 = time.perf_counter()
    want = {r.uid: np.asarray(seq.generate(r.tokens[None], r.max_new)[0],
                              np.int32) for r in reqs}
    dt_s = time.perf_counter() - t0

    same = sum(np.array_equal(out[r.uid], want[r.uid]) for r in reqs)
    first = _first_difference(reqs, out, want)
    assert first is None, (f"request {first[0]}: batched output diverged "
                           f"from sequential at token {first[1]}")
    print(f"{n_req} requests bit-for-bit identical to the copy-in engine "
          f"AND the sequential engine")

    st = eng.stats
    pool = st["pool"]
    print(f"batched   : {ntok / dt_b:8.0f} tok/s "
          f"(paged decode, {slots} slots, occupancy "
          f"{st['slot_occupancy']:.2f}, "
          f"{st.get('preemptions', 0)} preemptions)")
    print(f"sequential: {ntok / dt_s:8.0f} tok/s (batch=1 replay)")
    print(f"speedup   : {dt_s / dt_b:8.2f}x")
    print(f"KV pool   : {pool['pool_bytes_packed'] / 1e3:.1f} KB packed vs "
          f"{pool['pool_bytes_logical_f32'] / 1e3:.1f} KB logical f32 "
          f"({pool['peak_used']}/{pool['n_pages']} pages peak)")
    snap = eng.metrics.export()
    print(f"latency   : ttft p50 {snap['histograms']['ttft_ms']['p50']:.1f} ms"
          f", tbt p50 {snap['histograms']['tbt_ms']['p50']:.2f} ms "
          f"(F2P-estimated histograms)")

    res = {"paged": out, "sequential": want, "sequential_agree": same,
           "n_requests": n_req, "tokens": ntok,
           "pool_kb_packed": pool["pool_bytes_packed"] / 1e3,
           "pool_kb_logical_f32": pool["pool_bytes_logical_f32"] / 1e3,
           "peak_pages": pool["peak_used"], "n_pages": pool["n_pages"],
           "trace_events": None}
    if trace:
        res["trace_events"] = validate_trace(trace, reqs, eng)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default="",
                    help="write a Chrome/Perfetto trace_event JSON here "
                         "(arms obs tracing for the timed run)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    serve_continuous(require_device(args.device), trace=args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
