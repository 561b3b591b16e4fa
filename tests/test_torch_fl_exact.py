"""Port parity, exact FL aggregation: ``repro_torch.fl.exact`` against the
JAX reference's ``repro.fl.exact`` on the same bytes.

Every update is made by the reference (``QT.quantize`` on seeded numpy
data) and carried into the port by ``models.convert.update_from_jax``, so
both aggregators fold identical codes, words and scales. Tolerance: none.
The aggregation is integer work plus one f64 decode rounded once to f32,
so grid integers, folded results, rejections and overflows are compared
BITWISE / exactly. The second half holds the reference's own invariants
(``tests/test_exact_agg.py``) inside the port.
"""
import itertools

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qtensor as JQT
from repro.core.f2p import F2PFormat as JF2PFormat
from repro.core.f2p import Flavor as JFlavor
from repro.core.formats import format_name as jformat_name
from repro.fl import exact as JE
from repro_torch.core import qtensor as QT
from repro_torch.core.f2p import F2PFormat, Flavor
from repro_torch.fl.exact import (AggregationOverflow, ExactAggregator,
                                  UpdateRejected, aggregate_exact, grid_ints,
                                  validate_update)
from repro_torch.models.convert import update_from_jax

FMT8 = F2PFormat(8, 2, Flavor.SR, signed=True)
FMT6 = F2PFormat(6, 2, Flavor.SR, signed=True)
JFMT8 = JF2PFormat(8, 2, JFlavor.SR, signed=True)
JFMT6 = JF2PFormat(6, 2, JFlavor.SR, signed=True)


def to_port(jtree):
    """A reference update (dict of QTensor / arrays) -> the port's tree on
    the CPU, through the wire converter (same bytes)."""
    def parts(x):
        if isinstance(x, dict):
            return {k: parts(v) for k, v in x.items()}
        if isinstance(x, JQT.QTensor):
            return (np.asarray(x.codes), np.asarray(x.scales),
                    jformat_name(x.fmt), x.block, x.shape, x.packed)
        return np.asarray(x)

    return update_from_jax(parts(jtree))


def _jupdate(seed: int, *, packed: bool = True, scale_mode: str = "pow2",
             fmt=JFMT8, block: int = 32):
    """The reference test's update: a quantized matrix leaf + a raw bias."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.02, size=(4, 96)).astype(np.float32)
    b = rng.normal(0, 0.001, size=(24,)).astype(np.float32)
    return {"w": JQT.quantize(jnp.asarray(w), fmt, block=block, packed=packed,
                              scale_mode=scale_mode),
            "b": b}


def _update(seed, **kw):
    return to_port(_jupdate(seed, **kw))


def _np_leaves(tree):
    from repro_torch.fl._tree import leaves, to_numpy

    return [to_numpy(x) for x in leaves(tree, expand_q=True)]


def _bits_equal(a, b):
    fa, fb = _np_leaves(a), _np_leaves(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


def _bits_equal_ref(port, ref):
    """A port result tree against the reference's (numpy leaves)."""
    fr = [np.asarray(x) for x in jax.tree.leaves(ref)]
    fp = _np_leaves(port)
    assert len(fr) == len(fp)
    for x, y in zip(fp, fr):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


# ---------------------------------------------------------------------------
# parity: grid integers
# ---------------------------------------------------------------------------
_GRID_FORMATS = [(6, 2, "sr", True), (8, 2, "sr", True), (8, 1, "si", False),
                 (10, 2, "sr", True), (12, 2, "sr", True),
                 (16, 2, "sr", True), (12, 3, "sr", True)]


@pytest.mark.parametrize("n,h,fl,signed", _GRID_FORMATS)
def test_grid_ints_equal_reference(n, h, fl, signed):
    got = grid_ints(F2PFormat(n, h, Flavor(fl), signed=signed))
    want = JE.grid_ints(JF2PFormat(n, h, JFlavor(fl), signed=signed))
    if want is None:
        assert got is None       # the wide h=3 range: fixed-point path
        return
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype == np.int64
    assert got[1] == want[1]


# ---------------------------------------------------------------------------
# parity: folded results, bitwise
# ---------------------------------------------------------------------------
_CASES = {
    "packed-pow2": dict(packed=True, scale_mode="pow2"),
    "unpacked-pow2": dict(packed=False, scale_mode="pow2"),
    "packed-f32": dict(packed=True, scale_mode="f32"),
    "unpacked-f32": dict(packed=False, scale_mode="f32"),
    "6bit-packed-pow2": dict(packed=True, scale_mode="pow2", fmt=JFMT6),
    "6bit-unpacked-block64": dict(packed=False, scale_mode="pow2", fmt=JFMT6,
                                  block=64),
    "16bit-pow2": dict(packed=False, scale_mode="pow2",
                       fmt=JF2PFormat(16, 2, JFlavor.SR, signed=True)),
    "10bit-lr-packed-pow2": dict(packed=True, scale_mode="pow2",
                                 fmt=JF2PFormat(10, 1, JFlavor.LR,
                                                signed=True)),
}


@pytest.mark.parametrize("case", list(_CASES))
@pytest.mark.parametrize("weights", ["none", "ints", "with-zero"])
def test_aggregate_exact_bitwise_vs_reference(case, weights):
    kw = _CASES[case]
    jups = [_jupdate(s, **kw) for s in range(6)]
    ws = {"none": None, "ints": [1, 3, 2, 5, 4, 7],
          "with-zero": [2, 0, 1, 1, 3, 0]}[weights]
    if weights == "with-zero":
        # integer weights straight into the aggregator: 0 is a no-op
        ref, agg = JE.ExactAggregator(), ExactAggregator()
        for ju, w in zip(jups, ws):
            ref.add(ju, w)
            agg.add(to_port(ju), w)
        assert agg.n_folded == ref.n_folded == 4
        assert agg.total_weight == ref.total_weight
        _bits_equal_ref(agg.finalize(), ref.finalize())
        return
    ref = JE.aggregate_exact(jups, ws, weight_unit_bits=8)
    out = aggregate_exact([to_port(u) for u in jups], ws, weight_unit_bits=8)
    _bits_equal_ref(out, ref)


def test_mixed_codes_and_fixed_point_leaves_bitwise_vs_reference():
    """pow2 QTensor leaves (codes path), f32-scaled ones (dequantized, then
    fixed point) and raw leaves in one tree."""
    def mixed(s):
        a = _jupdate(s, packed=True, scale_mode="pow2")
        b = _jupdate(s + 100, packed=False, scale_mode="f32")
        return {"blocks": {"b0": {"wq": a["w"], "wk": b["w"]}},
                "bias": a["b"], "norm": b["b"]}

    jups = [mixed(s) for s in range(5)]
    ws = [256, 128, 64, 256, 1]
    ref, agg = JE.ExactAggregator(), ExactAggregator()
    for ju, w in zip(jups, ws):
        ref.add(ju, w)
        agg.add(to_port(ju), w)
    _bits_equal_ref(agg.finalize(), ref.finalize())


def test_add_batch_and_merge_bitwise_vs_reference():
    jups = [_jupdate(s) for s in range(8)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jups)
    ws = [256, 256, 0, 128, 256, 64, 256, 1]
    ref = JE.ExactAggregator()
    ref.add_batch(stacked, ws)
    agg = ExactAggregator()
    agg.add_batch(to_port(stacked), ws)
    _bits_equal_ref(agg.finalize(), ref.finalize())
    # merge of two shards in the other order
    r1, r2, p1, p2 = (JE.ExactAggregator(), JE.ExactAggregator(),
                      ExactAggregator(), ExactAggregator())
    for i, ju in enumerate(jups):
        (r1 if i % 2 else r2).add(ju, ws[i])
        (p1 if i % 2 else p2).add(to_port(ju), ws[i])
    r2.merge(r1)
    p2.merge(p1)
    _bits_equal_ref(p2.finalize(), r2.finalize())


def _poisoned():
    """Update variants and whether the reference's gate rejects each."""
    u = _jupdate(0, packed=False)
    q6 = JQT.quantize(jnp.asarray(np.ones((4, 96), np.float32)), JFMT6,
                      block=32, packed=False)
    wq = u["w"]
    variants = {
        "clean": u,
        "clean-packed": _jupdate(1, packed=True),
        "nan-scale": {"w": JQT.QTensor(wq.codes,
                                       jnp.asarray(np.asarray(wq.scales)
                                                   * np.nan),
                                       wq.fmt, wq.block, wq.shape, wq.packed),
                      "b": u["b"]},
        "zero-scale": {"w": JQT.QTensor(wq.codes,
                                        jnp.zeros_like(wq.scales),
                                        wq.fmt, wq.block, wq.shape,
                                        wq.packed), "b": u["b"]},
        "inf-bias": dict(u, b=np.float32([np.inf] * 24)),
        "6bit-code-oob": {"w": JQT.QTensor(jnp.full_like(q6.codes, 255),
                                           q6.scales, q6.fmt, q6.block,
                                           q6.shape, q6.packed),
                          "b": u["b"]},
        "6bit-code-max": {"w": JQT.QTensor(jnp.full_like(q6.codes, 63),
                                           q6.scales, q6.fmt, q6.block,
                                           q6.shape, q6.packed),
                          "b": u["b"]},
    }
    return variants


@pytest.mark.parametrize("name", list(_poisoned()))
def test_validate_update_rejects_what_reference_rejects(name):
    ju = _poisoned()[name]
    try:
        JE.validate_update(ju)
        want = None
    except JE.UpdateRejected as e:
        want = str(e)
    if want is None:
        validate_update(to_port(ju))
    else:
        with pytest.raises(UpdateRejected) as ei:
            validate_update(to_port(ju))
        assert str(ei.value) == want


def test_overflow_raised_where_reference_raises():
    lo = {"x": np.float32([1e-30, 1e-30])}
    hi = {"x": np.float32([1e30, 1e30])}
    near = {"x": np.float32([1e-29, 1e-31])}
    mid = {"x": np.float32([1e-3, 1e3])}
    one = {"x": np.float32([3.0, 4.0])}
    raised = []
    for a, b in ((lo, hi), (lo, near), (lo, mid), (mid, hi), (mid, one)):
        ref, agg = JE.ExactAggregator(), ExactAggregator()
        ref.add(a, 1)
        agg.add(to_port(a), 1)
        try:
            ref.add(b, 1)
        except JE.AggregationOverflow:
            raised.append(True)
            with pytest.raises(AggregationOverflow):
                agg.add(to_port(b), 1)
            continue
        raised.append(False)
        agg.add(to_port(b), 1)
        _bits_equal_ref(agg.finalize(), ref.finalize())
    assert raised[0] and not all(raised)   # both outcomes are exercised


# ---------------------------------------------------------------------------
# the reference's invariants, inside the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("packed", [True, False])
def test_32_client_permutation_invariance(packed):
    ups = [_update(s, packed=packed) for s in range(32)]
    ws = [1 + (s % 5) for s in range(32)]
    ref = aggregate_exact(ups, ws, weight_unit_bits=8)
    rng = np.random.default_rng(123)
    for _ in range(5):
        perm = rng.permutation(32)
        out = aggregate_exact([ups[i] for i in perm],
                              [ws[i] for i in perm], weight_unit_bits=8)
        _bits_equal(ref, out)


def test_mixed_codes_and_fallback_leaves_invariant():
    ups = [_update(s, scale_mode="f32") for s in range(8)]
    ref = aggregate_exact(ups)
    for perm in ([3, 1, 4, 0, 7, 5, 2, 6], [7, 6, 5, 4, 3, 2, 1, 0]):
        _bits_equal(ref, aggregate_exact([ups[i] for i in perm]))


def _stack(ups):
    """Lane-stacked update (the batched fleet shape)."""
    out = {}
    for k, v in ups[0].items():
        if isinstance(v, QT.QTensor):
            out[k] = QT.QTensor(torch.stack([u[k].codes for u in ups]),
                                torch.stack([u[k].scales for u in ups]),
                                v.fmt, v.block, v.shape, v.packed)
        else:
            out[k] = torch.stack([u[k] for u in ups])
    return out


def test_partial_arrival_schedules_bit_identical():
    ups = [_update(s) for s in range(32)]
    w = 256

    def sequential():
        agg = ExactAggregator()
        for u in ups:
            agg.add(u, w)
        return agg

    def batched_chunks():
        agg = ExactAggregator()
        for i0 in range(0, 32, 8):
            chunk = ups[i0:i0 + 8] + [ups[i0]]          # pad lane
            agg.add_batch(_stack(chunk), [w] * 8 + [0])
        return agg

    def sharded_merge():
        shards = [ExactAggregator() for _ in range(3)]
        for i, u in enumerate(ups):
            shards[i % 3].add(u, w)
        agg = ExactAggregator()
        for s in (shards[2], shards[0], shards[1]):
            agg.merge(s)
        return agg

    def straggler_split():
        agg = ExactAggregator()
        for u in ups[:29]:
            agg.add(u, w)
        late = ExactAggregator()
        for u in ups[29:]:
            late.add(u, w)
        agg.merge(late)
        return agg

    ref = sequential().finalize()
    for schedule in (batched_chunks, sharded_merge, straggler_split):
        _bits_equal(ref, schedule().finalize())


def test_codes_path_equals_f64_exact_mean():
    ups = [_update(s) for s in range(16)]
    out = aggregate_exact(ups, [256] * 16)
    deq = [u["w"].dequantize().numpy().astype(np.float64) for u in ups]
    exact = sum(d * 256 for d in deq) / (256 * 16)
    np.testing.assert_array_equal(out["w"], exact.astype(np.float32))


def test_weight_zero_is_exact_noop():
    ups = [_update(s) for s in range(4)]
    agg = ExactAggregator()
    for u in ups:
        agg.add(u, 16)
    ref = agg.finalize()
    agg2 = ExactAggregator()
    for u in ups:
        agg2.add(u, 16)
    agg2.add(_update(99), 0)
    assert agg2.n_folded == 4
    _bits_equal(ref, agg2.finalize())


def test_overflow_raises_not_wraps():
    agg = ExactAggregator()
    agg.add({"x": torch.tensor([1e-30, 1e-30])}, 1)
    with pytest.raises(AggregationOverflow):
        agg.add({"x": torch.tensor([1e30, 1e30])}, 1)


def test_validation_gate_rejects_poison():
    u = _update(0, packed=False)
    validate_update(u)
    w = u["w"]
    with pytest.raises(UpdateRejected, match="non-finite scales"):
        validate_update({"w": QT.QTensor(w.codes, w.scales * float("nan"),
                                         w.fmt, w.block, w.shape, w.packed),
                         "b": u["b"]})
    with pytest.raises(UpdateRejected, match="non-finite delta"):
        validate_update(dict(u, b=torch.full((24,), float("inf"))))
    q6 = QT.quantize(torch.ones(4, 96), FMT6, block=32, packed=False)
    oob = QT.QTensor(torch.full_like(q6.codes, 255), q6.scales, q6.fmt,
                     q6.block, q6.shape, q6.packed)
    with pytest.raises(UpdateRejected, match="out of range"):
        validate_update({"w": oob, "b": u["b"]})


def test_structure_and_shape_guards():
    agg = ExactAggregator()
    agg.add(_update(0), 1)
    with pytest.raises(UpdateRejected):
        agg.add({"w": _update(1)["w"]}, 1)           # missing leaf
    with pytest.raises(UpdateRejected):
        agg.add({"w": _update(1)["w"], "b": torch.zeros(7)}, 1)
    with pytest.raises(UpdateRejected):
        agg.add(_update(1), (1 << 24) + 1)   # weight above MAX_WEIGHT


def test_finalize_empty_raises():
    with pytest.raises(ValueError):
        ExactAggregator().finalize()
    with pytest.raises(ValueError):
        aggregate_exact([])


@pytest.mark.parametrize("seed", [0, 7, 4242])
@pytest.mark.parametrize("packed", [True, False])
def test_property_permutation_invariance(seed, packed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 8))
    ups, ws = [], []
    for _ in range(n):
        x = rng.normal(0, rng.uniform(1e-4, 10.0),
                       size=(2, 64)).astype(np.float32)
        ups.append({"w": QT.quantize(torch.from_numpy(x), FMT8, block=32,
                                     packed=packed, scale_mode="pow2"),
                    "b": torch.from_numpy(
                        rng.normal(0, 1, size=(8,)).astype(np.float32))})
        ws.append(int(rng.integers(1, 1000)))
    ref = aggregate_exact(ups, ws, weight_unit_bits=10)
    for perm in itertools.islice(itertools.permutations(range(n)), 1, 4):
        out = aggregate_exact([ups[i] for i in perm],
                              [ws[i] for i in perm], weight_unit_bits=10)
        _bits_equal(ref, out)
