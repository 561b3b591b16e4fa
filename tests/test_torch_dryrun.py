"""Port, the dry run (``launch.dryrun``) in fake worlds against the
reference's: whole-step FLOPs of the port's train, prefill and decode
steps (op analysis on fake tensors, a (1, 1) mesh of a fake world of one)
against the reference's ``hlo_flops`` of the same cells (``lower_cell``
on a (1, 1) mesh, in a subprocess with forced host devices, as
``tests/test_launch.py`` runs it), at smoke configs, seq 64, batch 4.
Exact for llama3.2-3b, scout and minicpm3 and for every prefill and
decode (dense and packed KV); xLSTM and jamba train within 2% (C28: the
mLSTM chunkwise backward's and the mamba readout's gradient products are
counted otherwise by torch's autograd and XLA). Then the production
(16, 16) fake world, the CLI's records, the report against the
reference's text, hillclimb, and a real step's count against the same
step on fake tensors."""
import json
import os
import subprocess
import sys

import _torch_threads  # noqa: F401
import pytest
import torch

import repro_torch.configs.registry as REG
from repro_torch.configs import smoke_config
from repro_torch.launch.dryrun import device_cell, lower_cell
from repro_torch.launch.mesh import compat_make_mesh, fake_world
from repro_torch.launch.op_analysis import analyze

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH = 64, 4
ARCHS = ("llama3_2_3b", "llama4_scout_17b", "minicpm3_4b", "xlstm_125m",
         "jamba_1_5_large")
CELLS = (("train_4k", False), ("prefill_32k", False), ("decode_32k", False),
         ("decode_32k", True))
# train FLOPs the port counts otherwise than XLA (C28), relative limit
TRAIN_GAP = {"xlstm_125m": 0.02, "jamba_1_5_large": 0.02}
SMALL = {"train_4k": (SEQ, BATCH, "train"),
         "prefill_32k": (SEQ, BATCH, "prefill"),
         "decode_32k": (SEQ, BATCH, "decode")}

_REF = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import repro.configs.registry as REG
from repro.configs import smoke_config
from repro.launch import roofline as RL
from repro.launch.dryrun import lower_cell
from repro.launch.mesh import compat_make_mesh
mesh = compat_make_mesh((1, 1), ("data", "model"))
REG.SHAPES.update({k: tuple(v) for k, v in json.loads(sys.argv[1]).items()})
out = {}
for arch, shape, q in json.loads(sys.argv[2]):
    c, cfg, meta = lower_cell(arch, shape, mesh, cfg=smoke_config(arch),
                              quantized_kv=q)
    seq, gb, kind = REG.SHAPES[shape]
    rl = RL.analyze(c, arch=arch, shape=shape, mesh_name="1x1", n_devices=1,
                    cfg=cfg, seq=seq, gbatch=gb, kind=kind)
    out[f"{arch} {shape} {q}"] = rl.hlo_flops
print("REF " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_flops():
    cells = [(a, s, q) for a in ARCHS for s, q in CELLS]
    r = subprocess.run(
        [sys.executable, "-c", _REF, json.dumps(SMALL), json.dumps(cells)],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("REF "))
    return json.loads(line[4:])


@pytest.fixture
def small_shapes(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setitem(REG.SHAPES, k, v)


@pytest.mark.parametrize("shape,quantized", CELLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_step_flops_match_reference(arch, shape, quantized, ref_flops,
                                    small_shapes):
    with fake_world(1):
        mesh = compat_make_mesh((1, 1), ("data", "model"), "cpu")
        counts, _, meta = lower_cell(arch, shape, mesh,
                                     cfg=smoke_config(arch),
                                     quantized_kv=quantized)
    ref = ref_flops[f"{arch} {shape} {quantized}"]
    assert counts["flops"] > 0
    if shape == "train_4k" and arch in TRAIN_GAP:
        assert counts["flops"] == pytest.approx(ref, rel=TRAIN_GAP[arch])
    else:
        assert counts["flops"] == ref
    assert meta["n_devices"] == 1 and meta["mesh"] == "1x1"
    assert counts["hbm_bytes"] > 0 and counts["temp_size_in_bytes"] > 0
    attn = any(b.mixer == "attn" for b in smoke_config(arch).pattern)
    if quantized and attn:   # the packed cache's write reaches B3
        assert counts["kernels"]["kv_write"]["count"] >= 1


def test_single_pod_flops_split_over_data_ranks():
    """(16, 16): each rank computes its 8 of the 128 rows of llama3.2-3b
    decode_32k (the model axis replicated, C24), so per-device FLOPs x 16
    are the (1, 1) count at the same global batch, exactly; the rank's
    parameter all-gathers are counted per leaf."""
    with fake_world(256):
        from repro_torch.launch.mesh import make_production_mesh

        mesh = make_production_mesh(device="cpu")
        pod, _, meta = lower_cell("llama3_2_3b", "decode_32k", mesh)
    with fake_world(1):
        one, _, _ = lower_cell("llama3_2_3b", "decode_32k", compat_make_mesh(
            (1, 1), ("data", "model"), "cpu"))
    assert pod["flops"] * 16 == one["flops"]
    assert meta["placement"].startswith("data parallel: 8 of 128 rows")
    assert pod["per_op"]["all-gather"]["count"] > 0
    assert "all-gather" not in one["per_op"]     # a (1, 1) mesh moves none


def test_dryrun_cli_records_and_report_match_reference(tmp_path, capsys):
    """The CLI writes the reference's record keys (the XLA-only memory
    keys left out), skips a full-attention long_500k with the reference's
    reason, and the port's report prints the reference's report's text on
    the same records."""
    import contextlib
    import io

    from repro.launch import report as ref_report

    from repro_torch.launch import dryrun, report

    out = str(tmp_path / "dry")
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama3_2_3b", "--shape", "decode_32k",
                     "--mesh", "single", "--out", out])
    assert e.value.code == 0
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "llama3_2_3b", "--shape", "long_500k",
                     "--mesh", "single", "--out", out])
    rec = json.load(open(os.path.join(out,
                                      "llama3_2_3b__decode_32k__16x16.json")))
    want = {"arch", "shape", "mesh", "kind", "seq", "global_batch",
            "n_devices", "quantized_kv", "hlo_flops", "hlo_bytes",
            "collective_bytes", "collective_bytes_naive", "model_flops",
            "memory_per_device", "per_op", "t_compute", "t_memory",
            "t_collective", "bottleneck", "useful_flops_ratio",
            "roofline_fraction", "status", "compile_s"}
    assert want <= set(rec)
    assert set(rec["memory_per_device"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes"}
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    skip = json.load(open(os.path.join(out,
                                       "llama3_2_3b__long_500k__16x16.json")))
    assert skip["status"] == "skipped"
    assert skip["reason"].startswith("pure full-attention arch")
    # two records of the reference's own shape beside the port's
    base = dict(rec, arch="other", shape="train_4k", bottleneck="collective",
                per_op={"all-reduce": {"count": 3, "bytes": 8.0,
                                       "moved": 12.0}})
    json.dump(base, open(os.path.join(out, "other__train_4k__16x16.json"),
                         "w"))
    json.dump(dict(arch="x", shape="decode_32k", mesh="2x16x16",
                   status="error", error="ValueError: no"),
              open(os.path.join(out, "x__decode_32k__2x16x16.json"), "w"))
    texts = []
    for mod in (report, ref_report):
        buf = io.StringIO()
        argv = sys.argv
        sys.argv = ["report", out]
        try:
            with contextlib.redirect_stdout(buf):
                mod.main()
        finally:
            sys.argv = argv
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    assert "| llama3_2_3b | decode_32k | ok |" in texts[0]


def test_hillclimb_variant_writes_its_record(tmp_path):
    from repro_torch.launch import hillclimb

    rec = hillclimb.run("llama3_2_3b", "decode_32k", "chunked,bwd_cast",
                        str(tmp_path))
    assert rec["variant"] == "chunked,bwd_cast"
    assert rec["hlo_flops"] > 0 and rec["mesh"] == "16x16"
    assert not torch.distributed.is_initialized()
    assert os.path.exists(tmp_path /
                          "llama3_2_3b__decode_32k__chunked+bwd_cast.json")


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_real_step_counts_equal_fake(kind):
    """The same one-device step counted on real CPU tensors and on fake
    ones (chip_smoke.py phase 16 holds the card's count to the fake one):
    FLOPs equal, bytes within 1e-6, the same temporaries."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rows, seq = (4, 64) if kind == "train" else (8, 128)
    step, args = device_cell("llama3_2_3b", kind, rows, seq, smoke=True,
                             device="cpu")
    _, real = analyze(step, *args)
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = device_cell("llama3_2_3b", kind, rows, seq, smoke=True,
                                 device="cpu", fake=True)
        _, fake = analyze(step, *args, fake=True)
    assert real["flops"] == fake["flops"] > 0
    assert real["hbm_bytes"] == pytest.approx(fake["hbm_bytes"], rel=1e-6)
    assert real["temp_size_in_bytes"] == pytest.approx(
        fake["temp_size_in_bytes"], rel=1e-5)
    assert real["argument_size_in_bytes"] == fake["argument_size_in_bytes"]
    assert real["kernels"] == fake["kernels"]
    want = {"train": {"ef_roundtrip"},
            "decode": {"kv_write", "attention_packed"}}[kind]
    assert set(real["kernels"]) == want
    assert torch.distributed.is_initialized() is False


def test_fake_step_leaves_the_rope_cache_real():
    """A step on fake tensors caches no fake tensor: the rope table it
    reads is made real, so a later real step on the same widths (another
    test on the same worker) gets a real table."""
    from torch._subclasses.fake_tensor import FakeTensorMode, is_fake

    from repro_torch.models import common

    cfg = smoke_config("llama3_2_3b")
    common._rope_freqs_on.cache_clear()
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = device_cell("llama3_2_3b", "decode", 2, 16, smoke=True,
                                 device="cpu", fake=True)
        analyze(step, *args, fake=True)
    assert common._rope_freqs_on.cache_info().currsize == 1
    t = common._rope_freqs_on(cfg.head_dim, float(cfg.rope_theta),
                              torch.device("cpu"))
    assert not is_fake(t)
    assert torch.equal(t, torch.tensor(
        common.rope_freqs(cfg.head_dim, cfg.rope_theta), dtype=torch.float32))
