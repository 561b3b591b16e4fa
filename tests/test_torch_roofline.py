"""Port, the launch analysis tools' pure parts: the op analysis
(``launch.op_analysis``) on small real CPU steps, twin for twin with the
reference's ``tests/test_hlo_analysis.py``; the kernels' costs
(``kernels.cost``) against ``FlopCounterMode`` and their plain versions;
the roofline's ring model, ``active_params`` and ``model_flops`` against
the reference's (``repro.launch.roofline`` imports no JAX); the
hillclimb knobs against the reference module's own (read from its source:
importing it sets ``XLA_FLAGS``); and the two device repairs of the train
CLI and ``rank_device``."""
import ast
import os

import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch import roofline as RL
from repro_torch.launch.op_analysis import OpAnalysis, analyze

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# twins of tests/test_hlo_analysis.py
# ---------------------------------------------------------------------------
def test_dot_flops_exact():
    x, w = torch.ones(32, 128), torch.ones(128, 64)
    _, a = analyze(lambda x, w: x @ w, x, w)
    assert a["flops"] == 2 * 32 * 128 * 64
    # operands and the result, each once
    assert a["hbm_bytes"] == 4 * (32 * 128 + 128 * 64 + 32 * 64)


def _body(x, w):
    return torch.tanh(x @ w)


def test_loop_flops_match_unrolled():
    W = torch.ones(8, 256, 256, dtype=torch.bfloat16)
    x = torch.ones(64, 256, dtype=torch.bfloat16)

    def looped(x, W):
        for i in range(W.shape[0]):
            x = _body(x, W[i])
        return x

    _, one = analyze(_body, x, W[0])
    _, a = analyze(looped, x, W)
    assert a["flops"] == 8 * one["flops"] == 2 * 64 * 256 * 256 * 8


def test_grad_of_loop_counts_bwd():
    W = torch.ones(8, 256, 256, dtype=torch.bfloat16, requires_grad=True)
    x = torch.ones(64, 256, dtype=torch.bfloat16, requires_grad=True)

    def loss_backward(x, W):
        y = x
        for i in range(W.shape[0]):
            y = _body(y, W[i])
        (y.float() ** 2).sum().backward()

    _, a = analyze(loss_backward, x, W)
    assert a["flops"] == 3 * 2 * 64 * 256 * 256 * 8  # fwd + 2 bwd matmuls


def test_nested_loops_multiply():
    c = torch.ones(64, 64)
    xs = torch.ones(3, 64, 64)

    def outer(c, xs):
        for _ in range(5):
            for j in range(xs.shape[0]):
                c = c @ xs[j]
        return c

    _, a = analyze(outer, c, xs)
    assert a["flops"] == 5 * 3 * 2 * 64 * 64 * 64


def test_loop_memory_not_billed_full_buffer():
    """A per-step slice of a stacked input is charged the slice, not the
    stack (a view is free; the op reads the slice)."""
    xs = torch.ones(1024, 64, 64)   # 16 MB stacked input
    c = torch.ones(64, 64)

    def loop(c, xs):
        sums = []
        for i in range(xs.shape[0]):
            sums.append(c.sum())
            c = c + xs[i]
        return c, sums

    _, a = analyze(loop, c, xs)
    assert a["hbm_bytes"] < 0.5e9, a["hbm_bytes"] / 1e9
    assert a["hbm_bytes"] >= 1024 * 3 * 64 * 64 * 4


def test_collectives_in_loop_counted_per_call():
    import torch.distributed as dist

    from repro_torch.launch.mesh import fake_world

    def step(c, xs):
        for i in range(xs.shape[0]):
            x = xs[i].clone()
            dist.all_reduce(x)
            c = c + x
        return c

    c, xs = torch.ones(64, 64), torch.ones(7, 64, 64)
    with fake_world(4):
        _, a = analyze(step, c, xs)
    ar = a["per_op"]["all-reduce"]
    assert ar["count"] == 7   # one per loop step
    assert ar["bytes"] == 7 * 64 * 64 * 4
    assert a["ring_bytes"] == ar["moved"] == 7 * 2 * 64 * 64 * 4 * 3 / 4


def test_while_loop_trip_count():
    """An eager loop that stops on a value runs its real trip count."""
    def f(x):
        n, y = 0, x
        while n < 23:
            n, y = n + 1, y @ y
        return y

    _, a = analyze(f, torch.ones(32, 32) / 32)
    assert a["flops"] == 23 * 2 * 32 ** 3


def test_temp_bytes_track_frees():
    """temp_size_in_bytes is the peak of the step's own live storages:
    a chain that frees each temporary holds two at a time."""
    x = torch.ones(1024, 1024)

    def chain(x):
        for _ in range(6):
            x = x * 2.0
        return x

    _, a = analyze(chain, x)
    assert a["temp_size_in_bytes"] == 2 * 4 * 1024 * 1024
    assert a["argument_size_in_bytes"] == 4 * 1024 * 1024
    assert a["output_size_in_bytes"] == 4 * 1024 * 1024


def test_inference_mode_composites_decompose():
    """Outside autograd ``matmul`` reaches the mode whole; it is counted
    as what it decomposes into."""
    x, w = torch.ones(4, 3, 16), torch.ones(16, 8)
    with torch.inference_mode():
        _, a = analyze(lambda x, w: x @ w, x, w)
    assert a["flops"] == 2 * 12 * 16 * 8


# ---------------------------------------------------------------------------
# the kernels' costs
# ---------------------------------------------------------------------------
def _fmt(name="f2p_sr_2_8s"):
    from repro_torch.core.formats import named_format

    return named_format(name)


def _qt(g, shape, fmt):
    from repro_torch.core import qtensor as QT

    x = torch.randn(*shape, generator=g)
    return QT.quantize(x, fmt, block=shape[-1], packed=True)


def _kernel_calls():
    """(name, wrapper, args, kwargs) of every charged kernel at small
    shapes, on CPU tensors."""
    from repro_torch.kernels import f2p_attention as A
    from repro_torch.kernels import f2p_counter as FC
    from repro_torch.kernels import f2p_matmul as MM
    from repro_torch.kernels import f2p_quant as Q
    from repro_torch.models.attention import init_cache

    g = torch.Generator().manual_seed(0)
    fmt = _fmt()
    B, S, K, G, hd, T = 2, 40, 2, 3, 16, 8
    q = torch.randn(B, 1, K * G, hd, generator=g)
    kq, vq = _qt(g, (B, S, K, hd), fmt), _qt(g, (B, S, K, hd), fmt)
    sk, sv = _qt(g, (12, T, K, hd), fmt), _qt(g, (12, T, K, hd), fmt)
    pages = torch.tensor([[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]], dtype=torch.int32)
    lens = torch.tensor([17, 33])

    class Cfg:
        n_kv_heads, head_dim = K, hd

    cache = init_cache(Cfg, B, S, True, torch.float32, "cpu", fmt=fmt)
    kv = torch.randn(B, 1, K, hd, generator=g)
    x2 = torch.randn(16, 256, generator=g)
    codes, scales = Q.f2p_quantize_codes(x2, fmt)
    words, pscales = Q.f2p_quantize_packed(x2, fmt)
    xm = torch.randn(8, 256, generator=g)
    w = torch.randn(256, 128, generator=g) * 0.02
    wc, ws = MM.quantize_weight(w, MM.WEIGHT_FMT)
    wp, wps = MM.quantize_weight(w, MM.WEIGHT_FMT, packed=True)
    st = torch.zeros(4, 64, dtype=torch.int32)
    grid = _fmt("f2p_lr_1_6s").payload_grid
    luts = [torch.from_numpy(t) for t in FC.advance_tables(grid)]
    budget = torch.full((4, 64), 3.0)
    gl = torch.tensor(grid, dtype=torch.float32)
    gs = [torch.randn(8, 256, generator=g).to(torch.bfloat16),
          torch.randn(300, generator=g)]
    rs = [torch.zeros(8, 256), torch.zeros(300)]
    return [
        ("attention_packed", A.attention_packed, (q, kq, vq),
         dict(kv_len=lens)),
        ("attention_packed", A.attention_packed, (q, kq, vq),
         dict(kv_len=21, tile=16)),
        ("attention_paged", A.attention_paged, (q, sk, sv, pages),
         dict(kv_len=lens)),
        ("attention_paged", A.attention_paged, (q, sk, sv, pages),
         dict(kv_len=None, tile=24)),
        ("kv_write", Q.f2p_kv_write, (kv, kv, cache, 5), {}),
        ("kv_read", Q.f2p_kv_read, (cache, torch.bfloat16), {}),
        ("quantize_packed", Q.f2p_quantize_packed, (x2, fmt), {}),
        ("dequantize_packed", Q.f2p_dequantize_packed, (words, pscales, fmt),
         {}),
        ("quantize", Q.f2p_quantize_codes, (x2, fmt), {}),
        ("dequantize", Q.f2p_dequantize_codes, (codes, scales, fmt),
         dict(out_dtype=torch.bfloat16)),
        ("ef_roundtrip", Q.f2p_ef_roundtrip, (gs, rs, fmt), {}),
        ("dequant_matmul", MM.f2p_dequant_matmul, (xm, wc, ws), {}),
        ("dequant_matmul_packed", MM.f2p_dequant_matmul_packed,
         (xm, wp, wps), {}),
        ("counter_advance", FC.counter_advance, (st, budget, *luts, 7), {}),
        ("counter_estimate", FC.counter_estimate, (st, gl), {}),
    ]


def test_every_launch_count_has_a_cost():
    from repro_torch.kernels import cost, cuda

    names = {c[0] for c in _kernel_calls()}
    assert names == set(cuda.LAUNCHES) == set(cost.COSTS)


@pytest.mark.parametrize("i", range(15))
def test_kernel_flops_equal_plain_flop_count(i):
    """Each kernel's ``flops`` equals FlopCounterMode's count of its plain
    version (what the wrapper runs on a CPU tensor)."""
    from repro_torch.kernels import cost

    name, fn, args, kw = _kernel_calls()[i]
    want = cost.flops(name, *args, **kw)
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kw)
    assert want == fc.get_total_flops(), name
    if name.startswith("attention"):
        assert want > 0


@pytest.mark.parametrize("i", range(15))
def test_kernel_fake_matches_plain_results(i):
    """``fake`` gives the plain version's result shapes and dtypes."""
    from repro_torch.kernels import cost

    name, fn, args, kw = _kernel_calls()[i]
    got = cost.COSTS[name].fake(cost.bind(name, args, kw))
    ref = fn(*args, **kw)
    flat = lambda r: [r] if isinstance(r, torch.Tensor) else list(r or ())
    assert [(tuple(t.shape), t.dtype) for t in flat(got)] == \
        [(tuple(t.shape), t.dtype) for t in flat(ref)], name


def test_kernel_bytes_count_what_the_bound_counts():
    """nbytes by hand: the KV write's rows (not the cache), B4's K+V read,
    B5 / B6, the round trip, attention's live rows, the matmul and the
    counters."""
    from repro_torch.kernels import cost

    calls = {(c[0], i): c for i, c in enumerate(_kernel_calls())}
    nb = {k: cost.nbytes(c[0], *c[2], **c[3]) for k, c in calls.items()}
    W = 4   # 16 8-bit fields in 32-bit words
    # K and V [2, 1, 2, 16] f32 in, 2 x 2 rows of 4 words + a scale out,
    # a start position per slot
    assert nb[("kv_write", 4)] == 2 * (2 * 2 * 16 * 4 + 2 * 2 * (4 * W + 4)) \
        + 8 * 2
    # the whole [2, 40, 2] cache of each side, bf16 out
    assert nb[("kv_read", 5)] == 2 * 160 * (W * 4 + 4 + 16 * 2)
    assert nb[("quantize", 8)] == 16 * 256 * (4 + 1) + 16 * 2 * 4
    assert nb[("dequantize", 9)] == 16 * 256 * (1 + 2) + 16 * 2 * 4
    assert nb[("quantize_packed", 6)] == 16 * 256 * 4 + 16 * 64 * 4 + 32 * 4
    assert nb[("ef_roundtrip", 10)] == 2 * 2048 * 2 + 2 * 2048 * 4 \
        + 2 * 300 * 4 + 2 * 300 * 4
    row = 2 * W * 4 + 8
    # live rows 17 + 33 at 2 kv heads, q in and out, the lengths
    assert nb[("attention_packed", 0)] == 50 * 2 * row + 2 * 2 * 6 * 16 * 4 \
        + 2 * 8
    assert nb[("attention_packed", 1)] == 2 * 21 * 2 * row \
        + 2 * 2 * 6 * 16 * 4 + 2 * 8
    # paged: plus each row's live page ids (3 + 5 pages of 8)
    assert nb[("attention_paged", 2)] == 50 * 2 * row + 2 * 2 * 6 * 16 * 4 \
        + 2 * 8 + 8 * 4
    assert nb[("dequant_matmul", 11)] == 256 * 128 + 2 * 128 * 4 \
        + 8 * 256 * 4 + 8 * 128 * 4
    assert nb[("counter_advance", 13)] == 16 * 256
    assert nb[("counter_estimate", 14)] == 8 * 256


def test_charged_kernel_counts_once_and_nothing_inside():
    """Under the analysis a kernel's call adds its cost once; the plain
    version's own ops (matmuls included) add nothing; with no analysis
    the wrapper runs as it is."""
    from repro_torch.kernels import cost

    name, fn, args, kw = _kernel_calls()[0]
    assert cost.ACTIVE is None
    ref = fn(*args, **kw)
    got, a = analyze(fn, *args, **kw)
    assert torch.equal(got, ref)
    assert cost.ACTIVE is None
    assert a["kernels"] == {name: {"count": 1,
                                   "bytes": cost.nbytes(name, *args, **kw),
                                   "flops": cost.flops(name, *args, **kw)}}
    assert a["flops"] == cost.flops(name, *args, **kw)
    assert a["hbm_bytes"] == cost.nbytes(name, *args, **kw)
    with pytest.raises(RuntimeError, match="running already"):
        with OpAnalysis(), OpAnalysis():
            pass
    assert cost.ACTIVE is None


def test_kernel_called_from_another_thread_is_not_charged():
    """The dispatch mode counts its own thread only: a wrapper called from
    another thread while an analysis runs runs as it is, uncharged."""
    import threading

    name, fn, args, kw = _kernel_calls()[0]
    ref = fn(*args, **kw)
    got = {}
    with OpAnalysis(fake=True) as an:
        t = threading.Thread(target=lambda: got.update(out=fn(*args, **kw)))
        t.start()
        t.join()
    assert torch.equal(got["out"], ref)
    assert an.result()["kernels"] == {} and an.hbm_bytes == 0


# ---------------------------------------------------------------------------
# the roofline against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_ring_model_matches_reference_parse(kind, n):
    from repro.launch.roofline import parse_collectives

    groups = "{{" + ",".join(str(i) for i in range(n)) + "}}"
    line = (f"  %c = f32[1024,8]{{1,0}} {kind}(f32[1024,8]{{1,0}} %p), "
            f"replica_groups={groups}")
    ref = parse_collectives(line, n)
    b = 1024 * 8 * 4
    assert ref["naive_bytes"] == b
    assert RL.moved_bytes(kind, b, n) == pytest.approx(ref["ring_bytes"],
                                                       rel=1e-15)


def test_roofline_properties():
    r = RL.Roofline(arch="a", shape="s", mesh="m", n_devices=256,
                    hlo_flops=RL.PEAK_FLOPS, hlo_bytes=RL.HBM_BW * 2,
                    collective_bytes=RL.LINK_BW * 3,
                    collective_bytes_naive=0,
                    model_flops=RL.PEAK_FLOPS * 256 * 0.5,
                    memory_per_device={}, per_op={})
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.t_collective == pytest.approx(3.0)
    assert r.bottleneck == "collective"
    assert r.roofline_fraction == pytest.approx(0.5 / 3.0)
    assert r.useful_flops_ratio == pytest.approx(0.5)
    d = r.to_dict()
    assert d["bottleneck"] == "collective" and d["t_memory"] == 2.0
    # the H100 80GB HBM3 (SXM5) data sheet's figures
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW) == (989.4e12, 3.35e12,
                                                      450e9)


@pytest.mark.parametrize("arch", ["minitron_4b", "llama3_2_3b", "minicpm3_4b",
                                  "codeqwen1_5_7b", "whisper_large_v3",
                                  "internvl2_1b", "llama4_maverick_400b",
                                  "llama4_scout_17b", "jamba_1_5_large",
                                  "xlstm_125m"])
def test_active_params_and_model_flops_match_reference(arch):
    from repro.configs import full_config as ref_full
    from repro.launch import roofline as ref_rl

    from repro_torch.configs import SHAPES, full_config

    cfg, rcfg = full_config(arch), ref_full(arch)
    assert RL.active_params(cfg) == ref_rl.active_params(rcfg)
    for shape, (seq, gb, kind) in SHAPES.items():
        assert RL.model_flops(cfg, shape, seq, gb, kind) == \
            ref_rl.model_flops(rcfg, shape, seq, gb, kind), shape


def test_hillclimb_knobs_match_reference():
    from repro_torch.launch.hillclimb import KNOBS

    src = open(os.path.join(ROOT, "src/repro/launch/hillclimb.py")).read()
    node = next(n for n in ast.parse(src).body
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "KNOBS")
    ref = {}
    for k, v in zip(node.value.keys, node.value.values):
        ref[ast.literal_eval(k)] = (
            {kw.arg: ast.literal_eval(kw.value) for kw in v.keywords}
            if isinstance(v, ast.Call) else ast.literal_eval(v))
    assert KNOBS == ref
    assert list(KNOBS) == list(ref)


# ---------------------------------------------------------------------------
# the device repairs: the card unless the CPU is asked for
# ---------------------------------------------------------------------------
def test_rank_device_raises_without_a_card(monkeypatch):
    from repro_torch.launch import mesh as M

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.rank_device(None)
    assert M.rank_device("cpu") == torch.device("cpu")


def test_train_cli_needs_device_cpu_without_a_card(monkeypatch, capsys):
    from repro_torch.launch import train as T

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.delenv("RANK", raising=False)
    assert T.main(["--mesh-shape", "2,2"]) != 0
    assert "--device cpu" in capsys.readouterr().err
    assert T.main(["--mesh-shape", "1,1", "--steps", "0"]) != 0
    assert "--device cpu" in capsys.readouterr().err
    assert T.mesh_backend(4, "cpu") == ("gloo", ["cpu"] * 4)
    with pytest.raises(RuntimeError, match="--device cpu"):
        T.mesh_backend(4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert T.mesh_backend(2) == ("nccl", ["cuda:0", "cuda:1"])
    assert T.mesh_backend(4) == ("gloo", ["cuda:0", "cuda:1", "cuda:0",
                                          "cuda:1"])
    assert T.parse_args(["--device", "cpu"]).device == "cpu"
    np.testing.assert_equal(T.parse_args([]).device, "cuda")
