"""Port parity, autotune: ``repro_torch.autotune.calibrate`` and the policy
solver against ``repro.autotune``.

The same numpy data goes through both packages' calibration. States are
held bitwise (counts, absmax, n, nblocks) in raw and block-normalized
modes, on the reference test cases (NaN, signed zeros, denormals, huge
values, scalars, ragged last dims, merges, trees); ``msq`` is an f32 sum
that XLA and torch take in different orders, held to 1e-6 relative
(ROADMAP C8). ``to_dist``, ``candidate_formats``, ``_leaf_bits`` and
``solve(...).to_dict()`` are host numpy in both packages and must be equal.
"""
import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.autotune import calibrate as JC
from repro.autotune import error_models as JE
from repro.autotune import policy as JP
from repro_torch import autotune as TA
from repro_torch.autotune import calibrate as TC
from repro_torch.autotune import error_models as TE
from repro_torch.autotune import policy as TP

EXACT_KEYS = ("counts", "absmax", "n", "nblocks")


def _jspec(spec: TC.HistSpec):
    return JC.HistSpec(spec.n_bins, spec.lo_log2, spec.hi_log2)


def _same_state(js: dict, ts: dict):
    assert set(js) == set(ts)
    for k in EXACT_KEYS:
        a, b = np.asarray(js[k]), ts[k].numpy()
        assert a.dtype == b.dtype == np.float32, k
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=k)
    np.testing.assert_allclose(ts["msq"].numpy(), np.asarray(js["msq"]),
                               rtol=1e-6, atol=0)


def _both(x, spec=TC.NORM_SPEC, block=None):
    js = JC.update(JC.empty_state(_jspec(spec)), jnp.asarray(x),
                   _jspec(spec), block)
    ts = TC.update(TC.empty_state(spec), torch.from_numpy(np.asarray(x)),
                   spec, block)
    return js, ts


RAW_SPEC = TC.HistSpec(n_bins=16, lo_log2=-8.0, hi_log2=8.0)


def test_raw_counts_bitwise():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.lognormal(0, 2, 4000), [0.0] * 7, [1e9] * 3,
                        [1e-9] * 5]).astype(np.float32)
    js, ts = _both(x, RAW_SPEC)
    _same_state(js, ts)
    assert ts["counts"].sum() == x.size


@pytest.mark.parametrize("shape,block", [((32, 64), 32), ((16, 128), 128),
                                         ((7, 300), 128), ((3, 5, 256), 128),
                                         ((2, 50), 128), ((1, 7), 4),
                                         ((4096,), 128)])
def test_block_normalized_bitwise(shape, block):
    rng = np.random.default_rng(sum(shape) + block)
    x = (rng.normal(0, 3.0, shape) * rng.lognormal(0, 2, shape)).astype(
        np.float32)
    x.reshape(-1)[::97] = 0.0
    js, ts = _both(x, block=block)
    _same_state(js, ts)


def test_nan_and_edge_inputs_bitwise():
    x = np.array([[0.0, -0.0, 5e-324, 1e30, np.nan, -1.5, 0.3]], np.float32)
    js, ts = _both(x, block=4)                     # ragged last dim
    _same_state(js, ts)
    assert ts["counts"][-1] == 1 and ts["counts"].sum() == 8
    _same_state(*_both(x, TC.HistSpec()))          # raw mode, default spec
    x = np.array([np.nan, -np.nan, np.inf, -np.inf, 1.0], np.float32)
    for block in (None, 2):
        _same_state(*_both(x, block=block))


@pytest.mark.parametrize("block", [None, 128])
def test_scalar_input_bitwise(block):
    js = JC.update(JC.empty_state(JC.NORM_SPEC), jnp.float32(3.5),
                   JC.NORM_SPEC, block)
    ts = TC.update(TC.empty_state(TC.NORM_SPEC), torch.tensor(3.5),
                   TC.NORM_SPEC, block)
    _same_state(js, ts)
    assert float(ts["n"]) == 1.0


def test_streams_and_merges_bitwise():
    spec = TC.NORM_SPEC
    rng = np.random.default_rng(2)
    a = rng.normal(size=(16, 128)).astype(np.float32)
    b = (rng.normal(size=(16, 128)) * 5).astype(np.float32)
    js = JC.update(JC.update(JC.empty_state(JC.NORM_SPEC), jnp.asarray(a),
                             JC.NORM_SPEC, 128), jnp.asarray(b),
                   JC.NORM_SPEC, 128)
    ts = TC.update(TC.update(TC.empty_state(spec), torch.from_numpy(a), spec,
                             128), torch.from_numpy(b), spec, 128)
    _same_state(js, ts)
    (ja, ta), (jb, tb) = _both(a, block=128), _both(b, block=128)
    _same_state(JC.merge(ja, jb), TC.merge(ta, tb))


def test_update_tree_bitwise_same_keys():
    rng = np.random.default_rng(4)
    tree = {"blocks": {"wq": rng.normal(size=(4, 256)).astype(np.float32),
                       "norm": np.ones((64,), np.float32)},
            "emb": [rng.normal(size=(8, 128)).astype(np.float32),
                    rng.normal(size=(2, 3)).astype(np.float32)],
            "ids": np.arange(10, dtype=np.int32),
            "step": np.float32(7.0), "none": None}
    jtree = {"blocks": {k: jnp.asarray(v) for k, v in tree["blocks"].items()},
             "emb": [jnp.asarray(v) for v in tree["emb"]],
             "ids": jnp.asarray(tree["ids"]), "step": jnp.float32(7.0),
             "none": None}
    ttree = {"blocks": {k: torch.from_numpy(v)
                        for k, v in tree["blocks"].items()},
             "emb": [torch.from_numpy(v) for v in tree["emb"]],
             "ids": torch.from_numpy(tree["ids"]), "step": torch.tensor(7.0),
             "none": None}
    for kw in ({}, {"min_size": 100, "prefix": "g/"}, {"block": None}):
        js = JC.update_tree({}, jtree, **kw)
        js = JC.update_tree(js, jtree, **kw)             # existing keys grow
        ts = TC.update_tree({}, ttree, **kw)
        ts = TC.update_tree(ts, ttree, **kw)
        assert sorted(js) == sorted(ts)
        for k in js:
            _same_state(js[k], ts[k])


def test_to_dist_scale_rms_leaf_summary_equal():
    rng = np.random.default_rng(3)
    x = rng.lognormal(-4, 1.5, (32, 384)).astype(np.float32)
    js, ts = _both(x, block=128)
    jd, td = JC.to_dist(js, JC.NORM_SPEC), TC.to_dist(ts, TC.NORM_SPEC)
    assert jd.edges == td.edges and jd.probs == td.probs
    assert TC.scale_rms(ts) == pytest.approx(JC.scale_rms(js), rel=1e-6)
    (jd2, jr), (td2, tr) = (JC.leaf_summary(x, 128),
                            TC.leaf_summary(torch.from_numpy(x), 128))
    assert jd2.edges == td2.edges and jd2.probs == td2.probs
    assert tr == pytest.approx(jr, rel=1e-6)
    (jh, ja), (th, ta) = (JC.histogram_of(x),
                          TC.histogram_of(torch.from_numpy(x)))
    assert jh.edges == th.edges and jh.probs == th.probs and ja == ta
    # the raw mode falls back to the global absmax: equal exactly
    jr_raw = JC.update(JC.empty_state(), jnp.asarray(x))
    tr_raw = TC.update(TC.empty_state(), torch.from_numpy(x))
    assert JC.scale_rms(jr_raw) == TC.scale_rms(tr_raw)
    with pytest.raises(ValueError):
        TC.to_dist(TC.empty_state())


@pytest.mark.parametrize("kw", [{}, {"n_bits": (6, 8)},
                                {"n_bits": (6, 8, 10, 16),
                                 "include_baselines": True},
                                {"n_bits": (8,), "signed": False,
                                 "flavors": ("sr", "li")}])
def test_candidate_formats_equal(kw):
    assert TP.candidate_formats(**kw) == JP.candidate_formats(**kw)


def _leaf_pair(i, rng):
    """The same LeafSpec in both packages: a seeded HistogramDist."""
    nb = int(rng.integers(4, 40))
    edges = tuple(np.concatenate([[0.0], np.sort(rng.uniform(0, 1, nb - 1)),
                                  [1.0]]).tolist())
    probs = rng.dirichlet(np.ones(nb)).tolist()
    last = int(rng.choice([32, 64, 128, 384]))
    size = last * int(rng.integers(1, 400))
    srms = float(rng.lognormal(-3, 1))
    return (JP.LeafSpec(f"l{i}", size, last, JE.HistogramDist(edges, tuple(
        probs)), srms),
            TP.LeafSpec(f"l{i}", size, last, TE.HistogramDist(edges, tuple(
                probs)), srms))


def _leaf_sets(seed, n):
    rng = np.random.default_rng(seed)
    pairs = [_leaf_pair(i, rng) for i in range(n)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("mode", ["packed", "storage"])
def test_leaf_bits_equal(mode):
    jl, tl = _leaf_sets(5, 12)
    for name in JP.candidate_formats(n_bits=(6, 8, 10, 16)):
        for block in (32, 128, 512):
            for a, b in zip(jl, tl):
                assert TP._leaf_bits(b, name, block, mode) == \
                    JP._leaf_bits(a, name, block, mode)
                assert TP._leaf_error(b, name) == JP._leaf_error(a, name)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("budget", [7.5, 9.25, 11.25])
def test_solve_policies_equal(seed, budget):
    jl, tl = _leaf_sets(seed, 6)
    cands = JP.candidate_formats(n_bits=(6, 8, 10, 12))
    # storage mode charges 6-bit codes as bytes
    for mode, b in (("packed", budget), ("storage", budget + 2.0)):
        jp = JP.solve(jl, cands, b, block=128, bits_mode=mode,
                      default_fmt="f2p_sr_2_8s")
        tp = TP.solve(tl, cands, b, block=128, bits_mode=mode,
                      default_fmt="f2p_sr_2_8s")
        assert tp.to_dict() == jp.to_dict()
        assert TP.FormatPolicy.from_json(jp.to_json()) == tp


def test_solve_equal_budget_ulp_roundtrip_and_infeasible():
    """The equal-budget round trip (sum(bits)/total, re-multiplied) never
    raises in either package; budgets below the cheapest raise in both."""
    rng = np.random.default_rng(7)
    for trial in range(20):
        jl, tl = zip(*[_leaf_pair(i, rng) for i in range(5)])
        total = sum(sp.size for sp in tl)
        budget = sum(TP._leaf_bits(sp, "f2p_sr_2_8s", 128)
                     for sp in tl) / total
        cands = TP.candidate_formats(n_bits=(8,))
        assert TP.solve(tl, cands, budget).to_dict() == \
            JP.solve(jl, cands, budget).to_dict()
    for solve in (JP.solve, TP.solve):
        with pytest.raises(ValueError, match="infeasible"):
            solve(tl if solve is TP.solve else jl,
                  TP.candidate_formats(n_bits=(8,)), 2.0)
        with pytest.raises(ValueError, match="no candidate"):
            solve(tl if solve is TP.solve else jl, [], 8.0)
    assert TP.solve([], TP.candidate_formats(), 8.0).to_dict() == \
        JP.solve([], JP.candidate_formats(), 8.0).to_dict()


def test_solve_from_calibrated_summaries_equal():
    """End to end: leaves calibrated by each package (the reference's toy
    leaves) solve to the same policy."""
    rng = np.random.default_rng(0)
    jl, tl = [], []
    for i, sigma in enumerate((0.5, 1.5, 3.0)):
        x = rng.lognormal(-4, sigma, (32, 128)).astype(np.float32)
        jd, jr = JC.leaf_summary(x, block=128)
        td, tr = TA.leaf_summary(torch.from_numpy(x), block=128)
        jl.append(JP.LeafSpec(f"leaf{i}", x.size, 128, jd, jr))
        tl.append(TA.LeafSpec(f"leaf{i}", x.size, 128, td, tr))
    cands = TA.candidate_formats(n_bits=(6, 8, 10, 12))
    for budget in (6.5, 8.25, 10.25, 12.25):
        assert TA.solve(tl, cands, budget).to_dict() == \
            JP.solve(jl, cands, budget).to_dict()


def test_exports_match_reference():
    import repro.autotune as JA

    assert sorted(TA.__all__) == sorted(set(JA.__all__) | {"mag_grid"})
