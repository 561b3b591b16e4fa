"""Port parity, measurement path: ``repro_torch`` counters, hashing, the
counter-advance / estimate kernels' plain versions, ``F2PSketch`` and
``SketchIngestEngine`` against the JAX reference.

Bitwise: advance tables, hash constants and row hashes (int64 keys that are
negative or >= 2^32), the uniform stream, the estimate gather, the advance
on unit grids / at saturation / with zero budget, and a whole sketch +
ingest engine on a unit grid (states, queries, heavy-hitter report).

Stated tolerance: on F2P grids the advance goes through an f32 ``log``,
and torch's and XLA's CPU ``log`` differ by one ulp on some inputs, which
flips ``ceil(log u / log q)`` in a few draws per million. Those cases must
agree on >= 99.99% of cells (the fraction measured is in the assertion
message); trajectories are held to 5-sigma CLT consistency with the host
``CounterArray`` oracle. Inputs come from numpy seeds; the reference runs
as its own tests run it (``backend="xla"`` / Pallas ``interpret=True``).
"""
import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import counters as JC
from repro.kernels import f2p_counter as JFC
from repro.serve.engine import SketchIngestEngine as JEngine
from repro.sketch import F2PSketch as JSketch
from repro.sketch import SketchConfig as JConfig
from repro.sketch import choose_grid as jchoose_grid
from repro.sketch import hashing as JH
from repro_torch.core import counters as TC
from repro_torch.core.f2p import F2PFormat, Flavor
from repro_torch.kernels import f2p_counter as FC
from repro_torch.serve import SketchIngestEngine
from repro_torch.sketch import (F2PSketch, SketchConfig, choose_grid,
                                fold_u64, hash_rows, hash_rows_np,
                                make_hash_params)
from repro_torch.telemetry import HeavyHitterTable

CPU = "cpu"
MIN_AGREE = 0.9999


def _grid(flavor, n_bits, h_bits=2):
    return F2PFormat(n_bits=n_bits, h_bits=h_bits,
                     flavor=Flavor(flavor)).payload_grid


def _luts(grid):
    return tuple(torch.from_numpy(t) for t in FC.advance_tables(grid))


# ---------------------------------------------------------------------------
# copied numpy: grids, advance tables, the counter oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("flavor", ["li", "si", "lr", "sr"])
@pytest.mark.parametrize("n_bits", [8, 12, 16])
def test_advance_tables_bitwise(flavor, n_bits):
    grid = _grid(flavor, n_bits)
    np.testing.assert_array_equal(grid, JC.f2p_li_grid(n_bits)
                                  if flavor == "li" else grid)
    for got, want in zip(FC.advance_tables(grid), JFC.advance_tables(grid)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_advance_tables_unit_grid_and_bad_grid():
    p, run, logq = FC.advance_tables(np.arange(10, dtype=np.float64))
    np.testing.assert_array_equal(p[:-1], 1.0)
    assert p[-1] == 0.0
    np.testing.assert_array_equal(run, np.arange(9, -1, -1, dtype=np.float32))
    np.testing.assert_array_equal(logq, 0.0)
    with pytest.raises(ValueError):
        FC.advance_tables(np.array([0.0, 1.0, 1.0]))


@pytest.mark.parametrize("n_bits", [8, 12])
def test_counter_grids_and_oracles_match_reference(n_bits):
    np.testing.assert_array_equal(TC.f2p_li_grid(n_bits),
                                  JC.f2p_li_grid(n_bits))
    np.testing.assert_array_equal(TC.f2p_si_grid(n_bits),
                                  JC.f2p_si_grid(n_bits))
    np.testing.assert_array_equal(TC.sead_grid(n_bits), JC.sead_grid(n_bits))
    a = TC.tune_morris(n_bits, 1e5)
    assert a == JC.tune_morris(n_bits, 1e5)
    np.testing.assert_array_equal(TC.morris_grid(n_bits, a),
                                  JC.morris_grid(n_bits, a))
    d = TC.tune_cedar(n_bits, 1e5)
    np.testing.assert_array_equal(TC.cedar_grid(n_bits, d),
                                  JC.cedar_grid(n_bits, d))
    g = TC.f2p_li_grid(n_bits)
    assert TC.on_arrival_mse(g, 300, trials=4, seed=3) == \
        JC.on_arrival_mse(g, 300, trials=4, seed=3)
    mine, ref = TC.CounterArray(64, g, seed=5), JC.CounterArray(64, g, seed=5)
    idx = np.random.default_rng(n_bits).integers(0, 64, 200)
    for arr in (mine, ref):
        arr.add(idx, np.full(200, 37))
    np.testing.assert_array_equal(mine.estimates(), ref.estimates())


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------
def _wide_keys(seed, n=4096):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(-(1 << 40), 1 << 40, n // 2),       # negative, >= 2^32
        rng.integers(0, 1 << 20, n // 4),
        np.array([-1, 0, 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 5,
                  -(1 << 31), (1 << 63) - 1, -(1 << 63)]),
        rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                     n // 4)]).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_hash_params_and_rows_bitwise(seed):
    a, b = make_hash_params(4, seed=seed)
    ja, jb = JH.make_hash_params(4, seed=seed)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    keys = _wide_keys(seed)
    for width in (1000, 4096, 1 << 20):
        want = np.asarray(JH.hash_rows(jnp.asarray(keys.astype(np.uint32)),
                                       jnp.asarray(ja), jnp.asarray(jb),
                                       width))
        np.testing.assert_array_equal(JH.hash_rows_np(keys, ja, jb, width),
                                      want)
        got = hash_rows(torch.from_numpy(keys), torch.from_numpy(
            a.astype(np.int64)), torch.from_numpy(b.astype(np.int64)), width)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(hash_rows_np(keys, a, b, width), want)
        # numpy constants and keys are accepted too
        np.testing.assert_array_equal(hash_rows(keys, a, b, width).numpy(),
                                      want)


def test_fold_u64_bitwise():
    rng = np.random.default_rng(4)
    hi, lo = _wide_keys(1, 1024), _wide_keys(2, 1024)
    want = np.asarray(JH.fold_u64(jnp.asarray(hi.astype(np.uint32)),
                                  jnp.asarray(lo.astype(np.uint32))))
    got = fold_u64(torch.from_numpy(hi), torch.from_numpy(lo))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    h32 = rng.integers(0, 1 << 32, 64, dtype=np.uint32)
    np.testing.assert_array_equal(
        fold_u64(h32, h32[::-1].copy()).numpy(),
        np.asarray(JH.fold_u64(h32, h32[::-1])).astype(np.int64))


def test_hash_rows_spread():
    a, b = make_hash_params(4, seed=1)
    idx = hash_rows(torch.arange(8192), a, b, 512).numpy()
    assert idx.min() >= 0 and idx.max() < 512
    assert not np.array_equal(idx[0], idx[1])
    for d in range(4):
        assert np.bincount(idx[d], minlength=512).max() < 48


# ---------------------------------------------------------------------------
# the uniform stream and the plain kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 0x9E3779B1, 0xFFFFFFFF])
def test_hash_uniforms_bitwise(seed):
    rows, width = 3, 777
    u = FC.hash_uniforms(seed, 0, 41, (rows, width))
    assert u.shape == (rows, 41, width) and u.dtype == torch.float32
    lanes = jnp.arange(rows * width, dtype=jnp.uint32).reshape(rows, width)
    for t in range(41):
        want = np.asarray(JFC._hash_uniform(jnp.uint32(seed), jnp.uint32(t),
                                            lanes))
        np.testing.assert_array_equal(u[:, t].numpy(), want)
    np.testing.assert_array_equal(
        FC.hash_uniforms(seed, 25, 16, (rows, width)).numpy(),
        u[:, 25:41].numpy())
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0


@pytest.mark.parametrize("n_bits", [8, 12, 16])
def test_counter_estimate_bitwise(n_bits):
    grid = _grid("li", n_bits)
    state = np.random.default_rng(n_bits).integers(
        0, len(grid), (3, 1024)).astype(np.int32)
    glut = np.asarray(grid, np.float32)
    want = np.asarray(JFC.counter_estimate_pallas(
        jnp.asarray(state), jnp.asarray(glut), interpret=True))
    st, gl = torch.from_numpy(state), torch.from_numpy(glut)
    np.testing.assert_array_equal(FC.counter_estimate_plain(st, gl).numpy(),
                                  want)
    np.testing.assert_array_equal(FC.counter_estimate(st, gl).numpy(), want)
    np.testing.assert_array_equal(FC.counter_estimate(st[0], gl).numpy(),
                                  want[0])


def _pallas(state, budget, u, grid):
    p, run, logq = (jnp.asarray(t) for t in JFC.advance_tables(grid))
    st, lf = JFC._advance_pallas_jit(
        jnp.asarray(state), jnp.asarray(budget), jnp.asarray(u), p, run,
        logq, sweeps=u.shape[1], kmax=len(grid) - 1, interpret=True)
    return np.asarray(st), np.asarray(lf)


def _plain(state, budget, u, grid):
    st, lf = FC.counter_advance_plain(torch.from_numpy(state),
                                      torch.from_numpy(budget),
                                      *_luts(grid), torch.from_numpy(u))
    assert st.dtype == torch.int32 and lf.dtype == torch.float32
    return st.numpy(), lf.numpy()


@pytest.mark.parametrize("K", [8, 1 << 10, 1 << 14])
def test_counter_advance_plain_unit_grid_bitwise(K):
    """Unit grids (deterministic), saturation and zero budget: equal to the
    Pallas kernel (interpret) given the same uniforms."""
    grid = np.arange(K, dtype=np.float64)
    rng = np.random.default_rng(K)
    rows, width = 4, 512
    state = rng.integers(0, K, (rows, width)).astype(np.int32)
    budget = rng.integers(0, 2 * K, (rows, width)).astype(np.float32)
    budget[0] = 0.0                         # zero budget: unchanged
    budget[1, :64] = 10.0 * K               # far past saturation
    u = FC.hash_uniforms(5, 0, FC.PALLAS_SWEEPS, (rows, width)).numpy()
    got, want = _plain(state, budget, u, grid), _pallas(state, budget, u,
                                                        grid)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][0], state[0])
    assert (got[0][1, :64] == K - 1).all()
    np.testing.assert_array_equal(got[0], np.minimum(state + budget, K - 1))
    assert (got[1] == 0).all()


@pytest.mark.parametrize("flavor", ["li", "si", "sr"])
@pytest.mark.parametrize("n_bits", [8, 12, 16])
def test_counter_advance_plain_f2p_grids_vs_pallas(flavor, n_bits):
    """Same uniforms, stochastic states: agree on >= 99.99% of cells."""
    grid = _grid(flavor, n_bits)
    rng = np.random.default_rng(100 + n_bits)
    rows, width = 8, 8192
    state = rng.integers(0, len(grid) - 1, (rows, width)).astype(np.int32)
    budget = rng.integers(0, 5000, (rows, width)).astype(np.float32)
    budget[:, :256] = 0.0
    u = FC.hash_uniforms(int(rng.integers(0, 1 << 32)), 0, 16,
                         (rows, width)).numpy()
    (st, lf), (rst, rlf) = (_plain(state, budget, u, grid),
                            _pallas(state, budget, u, grid))
    agree = float(((st == rst) & (lf == rlf)).mean())
    assert agree >= MIN_AGREE, f"{agree:.6f} of cells agree"
    np.testing.assert_array_equal(st[:, :256], state[:, :256])


def test_counter_advance_cpu_wrapper_is_plain_on_the_stream():
    grid = _grid("li", 12)
    rng = np.random.default_rng(3)
    state = torch.from_numpy(rng.integers(0, 2000, (2, 300)).astype(np.int32))
    budget = torch.from_numpy(rng.integers(0, 900, (2, 300)).astype(
        np.float32))
    for sweep0, sweeps in ((0, 16), (32, 16), (7, 3)):
        got = FC.counter_advance(state, budget, *_luts(grid), 99,
                                 sweep0=sweep0, sweeps=sweeps)
        u = FC.hash_uniforms(99, sweep0, sweeps, (2, 300))
        want = FC.counter_advance_plain(state, budget, *_luts(grid), u)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    # 1-D state: lanes are the flat index
    g1 = FC.counter_advance(state[0], budget[0], *_luts(grid), 99)
    g2 = FC.counter_advance(state[:1], budget[:1], *_luts(grid), 99)
    assert torch.equal(g1[0], g2[0][0]) and torch.equal(g1[1], g2[1][0])
    with pytest.raises(ValueError):
        FC.counter_advance(state, budget[:1], *_luts(grid), 1)


def test_counter_advance_exact_is_one_stream():
    """Chunks of 16 sweeps with sweep0 += 16 equal one long run."""
    grid = _grid("li", 8)
    rng = np.random.default_rng(8)
    state = torch.zeros(2, 256, dtype=torch.int32)
    budget = torch.from_numpy(rng.integers(0, 3000, (2, 256)).astype(
        np.float32))
    st, lf = FC.counter_advance_exact(state, budget, *_luts(grid), 17)
    assert float(lf.abs().sum()) == 0.0
    u = FC.hash_uniforms(17, 0, 512, (2, 256))
    pst, plf = FC.counter_advance_plain(state, budget, *_luts(grid), u)
    assert float(plf.sum()) == 0.0
    assert torch.equal(st, pst)
    one_call = FC.counter_advance(state, budget, *_luts(grid), 17)
    assert float(one_call[1].sum()) > 0     # so the loop really chunked


@pytest.mark.parametrize("n_bits,budget", [(8, 3000.0), (12, 2500.0),
                                           (16, 6000.0)])
def test_counter_advance_exact_vs_xla(n_bits, budget):
    grid = _grid("li", n_bits)
    key = jax.random.PRNGKey(n_bits)
    seed = int(jax.random.bits(key, (), jnp.uint32))
    rng = np.random.default_rng(n_bits)
    cells = (4, 2048)
    state = np.zeros(cells, np.int32)
    b = rng.integers(0, int(budget), cells).astype(np.float32)
    p, run, logq = (jnp.asarray(t) for t in JFC.advance_tables(grid))
    rst, rlf = JFC.counter_advance_xla(jnp.asarray(state), jnp.asarray(b),
                                       p, run, logq, key)
    st, lf = FC.counter_advance_exact(torch.from_numpy(state),
                                      torch.from_numpy(b), *_luts(grid), seed)
    assert float(lf.abs().sum()) == 0.0 and float(jnp.sum(rlf)) == 0.0
    agree = float((st.numpy() == np.asarray(rst)).mean())
    assert agree >= MIN_AGREE, f"{agree:.6f} of cells agree"


@pytest.mark.parametrize("flavor", ["li", "si"])
@pytest.mark.parametrize("n_bits", [8, 12, 16])
def test_advance_consistent_with_counter_array(flavor, n_bits):
    """The port's trajectory against the port's host CounterArray: both
    unbiased estimators of the budget, means within 5 sigma."""
    grid = _grid(flavor, n_bits)
    budget = max(min(float(grid[-1]) * 0.05, 2e4), 50.0)
    n_dev, n_host = 2048, 256
    st, lf = FC.counter_advance_exact(
        torch.zeros(n_dev, dtype=torch.int32),
        torch.full((n_dev,), budget), *_luts(grid), n_bits)
    assert float(lf.sum()) == 0.0
    dev = FC.counter_estimate(st, torch.tensor(grid, dtype=torch.float32)
                              ).numpy().astype(np.float64)
    host_arr = TC.CounterArray(n_host, grid, seed=n_bits)
    host_arr.add(np.arange(n_host), np.full(n_host, int(budget)))
    host = host_arr.estimates()
    se = np.sqrt(dev.var() / n_dev + host.var() / n_host)
    tol = 5.0 * max(se, 1e-9) + 1e-6 * budget
    assert abs(dev.mean() - host.mean()) < tol
    if budget <= 0.25 * float(grid[-1]):
        assert abs(dev.mean() - budget) < \
            5.0 * np.sqrt(dev.var() / n_dev) + 1e-6 * budget + 1.0


# ---------------------------------------------------------------------------
# choose_grid
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_count,target", [(1e5, None), (2e6, 1e4),
                                              (3e7, None), (100.0, 50.0)])
def test_choose_grid_matches_reference(max_count, target):
    fmt, grid = choose_grid(max_count, target)
    jfmt, jgrid = jchoose_grid(max_count, target)
    assert (fmt.n_bits, fmt.h_bits, fmt.flavor.value) == \
        (jfmt.n_bits, jfmt.h_bits, jfmt.flavor.value)
    np.testing.assert_array_equal(grid, jgrid)
    cfg = SketchConfig.for_requirements(max_count, target, depth=3)
    jcfg = JConfig.for_requirements(max_count, target, depth=3)
    assert (cfg.n_bits, cfg.h_bits, cfg.flavor, cfg.depth) == \
        (jcfg.n_bits, jcfg.h_bits, jcfg.flavor, jcfg.depth)
    with pytest.raises(ValueError):
        choose_grid(1e12, n_bits_options=(8,))


# ---------------------------------------------------------------------------
# the sketch and the ingest engine against the reference
# ---------------------------------------------------------------------------
UNIT = np.arange(1 << 14, dtype=np.float64)


def _pair(conservative=False, width=512, depth=4, seed=11, grid=UNIT):
    kw = dict(depth=depth, width=width, seed=seed, conservative=conservative)
    return (F2PSketch(SketchConfig(**kw), grid=grid, device=CPU),
            JSketch(JConfig(backend="xla", **kw), grid=grid))


@pytest.mark.parametrize("conservative", [False, True])
@pytest.mark.parametrize("tensor_batches", [False, True])
def test_sketch_unit_grid_bitwise_vs_reference(conservative, tensor_batches):
    mine, ref = _pair(conservative)
    rng = np.random.default_rng(21)
    for n in (4096, 999, 2500):
        keys = rng.integers(0, 3000, n)
        counts = rng.integers(0, 4, n).astype(np.float32)
        if tensor_batches:
            mine.update(torch.from_numpy(keys), torch.from_numpy(counts))
            ref.update(jnp.asarray(keys), jnp.asarray(counts))
        else:
            mine.update(keys, counts)
            ref.update(keys, counts)
    assert mine.flush() == 0.0 and mine.pending_budget == 0.0
    ref.flush()
    np.testing.assert_array_equal(mine.state.numpy(), np.asarray(ref.state))
    q = np.arange(3000)
    np.testing.assert_array_equal(mine.query(q), ref.query(q))
    np.testing.assert_array_equal(mine.estimates(), ref.estimates())
    assert mine.arrivals == ref.arrivals
    assert mine.fill() == pytest.approx(ref.fill())
    assert mine.nbytes == ref.nbytes


@pytest.mark.parametrize("conservative", [False, True])
def test_ingest_engine_unit_grid_bitwise_vs_reference(conservative):
    mine, ref = _pair(conservative, width=1024)
    eng = SketchIngestEngine(mine, batch=1024, track_top=16)
    jeng = JEngine(ref, batch=1024, track_top=16)
    rng = np.random.default_rng(6)
    keys = (rng.zipf(1.5, size=9000) - 1) % 5000
    pos = 0
    while pos < keys.size:
        n = int(rng.integers(100, 2000))
        eng.ingest(keys[pos:pos + n])
        jeng.ingest(keys[pos:pos + n])
        pos += n
    eng.flush()
    jeng.flush()
    np.testing.assert_array_equal(mine.state.numpy(), np.asarray(ref.state))
    rep, jrep = eng.heavy_hitters(10), jeng.heavy_hitters(10)
    np.testing.assert_array_equal(rep.keys, jrep.keys)
    np.testing.assert_array_equal(rep.estimates, jrep.estimates)
    np.testing.assert_array_equal(rep.shares, jrep.shares)
    assert rep.to_dict() == jrep.to_dict()
    st, jst = eng.stats(), jeng.stats()
    for k in ("packets", "batches", "buffered", "sketch_fill",
              "sketch_bytes", "pending_budget"):
        assert st[k] == jst[k], k
    assert st["device"] == "cpu"
    assert eng.metrics.export()["counters"] == \
        jeng.metrics.export()["counters"]


def test_from_state_loads_a_reference_sketch():
    cfg = dict(depth=4, width=2048, n_bits=12, seed=3)
    ref = JSketch(JConfig(backend="xla", **cfg))
    keys = np.random.default_rng(2).zipf(1.3, 20000) % 7000
    ref.update(keys)
    mine = F2PSketch.from_state(SketchConfig(**cfg), np.asarray(ref.state),
                                np.asarray(ref._carry), device=CPU)
    q = np.arange(7000)
    np.testing.assert_array_equal(mine.query(q), ref.query(q))
    np.testing.assert_array_equal(mine.estimates(), ref.estimates())
    with pytest.raises(ValueError):
        F2PSketch.from_state(SketchConfig(**cfg), np.zeros((2, 2)),
                             device=CPU)


def test_sketch_host_and_device_paths_agree_in_cells():
    cfg = SketchConfig(depth=4, width=512, seed=11)
    keys = np.random.default_rng(2).integers(0, 4000, size=4096)
    sk_h = F2PSketch(cfg, grid=UNIT, device=CPU)
    sk_d = F2PSketch(cfg, grid=UNIT, device=CPU)
    sk_h.update(keys)
    sk_d.update(torch.from_numpy(keys))
    assert torch.equal(sk_h.state, sk_d.state)
    assert sk_h.arrivals == sk_d.arrivals == 4096.0


def test_sketch_counts_padding_and_ceiling():
    sk = F2PSketch(SketchConfig(depth=2, width=256), grid=UNIT[:4096],
                   device=CPU)
    sk.update(np.array([5, 9, 5, 0]), np.array([3.0, 2.0, 1.0, 0.0]))
    est = sk.query(np.array([5, 9, 0]))
    assert est.tolist() == [4.0, 2.0, 0.0]
    assert sk.arrivals == 6.0
    with pytest.raises(ValueError):
        sk.update(np.array([1]), np.array([float(FC.MAX_EXACT_BUDGET + 1)]))
    with pytest.raises(ValueError):
        sk.update(torch.tensor([1]),
                  torch.tensor([float(FC.MAX_EXACT_BUDGET + 2)]))
    sk.update(torch.arange(32))
    sk.update(torch.arange(16), torch.full((16,), 2.0))
    assert sk.arrivals == 70.0
    # a mesh must be a 1-D DeviceMesh (the row-sharded sketch)
    with pytest.raises(TypeError, match="DeviceMesh"):
        F2PSketch(SketchConfig(), device=CPU, mesh=object())


def test_sketch_overestimates_and_conservative_not_worse():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 2000, size=8192)
    base = F2PSketch(SketchConfig(depth=4, width=64), grid=UNIT, device=CPU)
    cons = F2PSketch(SketchConfig(depth=4, width=64, conservative=True),
                     grid=UNIT, device=CPU)
    base.update(keys)
    cons.update(keys)
    uniq, cnt = np.unique(keys, return_counts=True)
    e_base, e_cons = base.query(uniq), cons.query(uniq)
    assert np.all(e_base >= cnt) and np.all(e_cons >= cnt)
    assert e_cons.sum() <= e_base.sum()
    # CU with a duplicated key in a tensor batch keeps the guarantee
    cons.update(torch.full((200,), 7))
    assert cons.query(np.array([7]))[0] >= cnt[uniq == 7].sum() + 200


def test_engine_flush_drains_carry_and_refreshes_report():
    sk = F2PSketch(SketchConfig(depth=2, width=256, n_bits=8), device=CPU)
    eng = SketchIngestEngine(sk, batch=1024, track_top=16)
    eng.ingest(np.full(3000, 42))
    assert sk.pending_budget > 0          # 16 sweeps cannot spend it all
    eng.flush()
    assert sk.pending_budget == 0.0
    est = sk.query(np.array([42]))[0]
    assert abs(est - 3000) / 3000 < 0.25
    rep = eng.heavy_hitters(1)
    assert rep.keys[0] == 42 and rep.estimates[0] == pytest.approx(est)
    assert eng.packets == 3000 and eng.batches == 3
    snap = eng.metrics.export()
    assert snap["histograms"]["flush_depth"]["count"] == 1
    assert snap["gauges"]["arrivals_per_s"] > 0


def test_engine_rebatching_exact_totals():
    sk = F2PSketch(SketchConfig(depth=2, width=512), grid=UNIT, device=CPU)
    eng = SketchIngestEngine(sk, batch=1024)
    rng = np.random.default_rng(5)
    total = 0
    for n in (100, 1023, 1, 2048, 777):
        eng.ingest(rng.integers(0, 300, size=n))
        total += n
    eng.flush()
    assert eng.packets == total == sk.arrivals
    assert eng.stats()["buffered"] == 0


def test_engine_heavy_hitters_recovered():
    """Mirrors the reference's heavy-hitter test: 16-bit cells, Zipf 1.5."""
    sk = F2PSketch(SketchConfig(depth=4, width=2048, n_bits=16), device=CPU)
    eng = SketchIngestEngine(sk, batch=4096, track_top=64)
    rng = np.random.default_rng(6)
    keys = (rng.zipf(1.5, size=60000) - 1) % 100000
    eng.ingest(keys)
    eng.flush()
    rep = eng.heavy_hitters(10)
    uniq, cnt = np.unique(keys, return_counts=True)
    order = np.argsort(cnt)[::-1]
    assert set(uniq[order[:5]].tolist()) <= set(rep.keys.tolist())
    assert rep.total_arrivals == 60000
    truth = dict(zip(uniq.tolist(), cnt.tolist()))
    for k, e in zip(rep.keys[:5], rep.estimates[:5]):
        assert abs(e - truth[int(k)]) / truth[int(k)] < 0.05
    assert "heavy hitters" in str(rep)
    assert len(rep.to_dict()["flows"]) == len(rep.keys)


def test_heavy_hitter_table_bounded_and_fresh():
    t = HeavyHitterTable(capacity=4)
    t.offer(np.array([1, 2, 3, 4, 5]), np.array([10, 20, 30, 40, 50.0]))
    assert len(t) == 4
    np.testing.assert_array_equal(t.report(2).keys, [5, 4])
    t.offer(np.array([2]), np.array([100.0]))
    assert t.report(1).keys[0] == 2
    rep = t.report(4, total_arrivals=1000.0, min_share=0.05)
    assert np.all(rep.shares >= 0.05)
    assert t.report(1, total_arrivals=0.0).shares[0] == 0.0
