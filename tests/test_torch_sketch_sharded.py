"""Port, the row-sharded sketch and the sharded FL fleet chunk.

- B9's lane base: the advance of a row shard with ``lane_base`` = its
  first cell's global index equals the same rows of the whole state's
  advance, bit for bit (the plain version here; ``chip_smoke.py`` phase 15
  holds the kernel on the card), for one call and for the exact drain.
- ``F2PSketch(mesh=make_sketch_mesh(2))`` on two gloo ranks (one spawn),
  fed numpy and tensor batches and flushed: every rank's gathered state,
  estimates, queries, fill, pending budget and arrivals EQUAL the
  unsharded sketch's, and so do a conservative sketch's estimates.
- ``fl.rounds._maybe_shard`` puts a chunk's lanes on devices in equal runs
  (unchanged with one device, ``shard_clients`` off or a ``client_batch``
  the device count does not divide), and a fleet run whose chunks are
  split over 2 or 4 devices is bitwise the unsplit run (each lane is
  computed on its own, C17).
"""
import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

import _torch_dist as D
from repro_torch.fl import _tree
from repro_torch.fl import rounds as R
from repro_torch.fl.client import ClientConfig
from repro_torch.kernels import f2p_counter as FC
from repro_torch.sketch import F2PSketch, SketchConfig

CPU = "cpu"
SK = dict(depth=4, width=512, n_bits=12, h_bits=2, flavor="li", seed=3)


def _luts(grid):
    return tuple(torch.from_numpy(t) for t in FC.advance_tables(grid))


def test_lane_base_advance_bitwise():
    from repro_torch.core.f2p import F2PFormat, Flavor

    grid = F2PFormat(n_bits=12, h_bits=2, flavor=Flavor.LI).payload_grid
    rng = np.random.default_rng(0)
    W = 300
    state = torch.from_numpy(rng.integers(0, 200, size=(4, W)).astype(
        np.int32))
    budget = torch.from_numpy(rng.integers(0, 5000, size=(4, W)).astype(
        np.float32))
    full = FC.counter_advance(state, budget, *_luts(grid), 1234, sweep0=32)
    exact = FC.counter_advance_exact(state, budget, *_luts(grid), 99)
    u = FC.hash_uniforms(1234, 32, 4, (4, W))
    for r0, r1 in ((0, 1), (1, 3), (3, 4)):
        part = FC.counter_advance(state[r0:r1], budget[r0:r1], *_luts(grid),
                                  1234, sweep0=32, lane_base=r0 * W)
        for a, b in zip(part, full):
            assert torch.equal(a, b[r0:r1]), (r0, r1)
        ex = FC.counter_advance_exact(state[r0:r1], budget[r0:r1],
                                      *_luts(grid), 99, lane_base=r0 * W)
        assert torch.equal(ex[0], exact[0][r0:r1])
        assert torch.equal(FC.hash_uniforms(1234, 32, 4, (r1 - r0, W),
                                            lane_base=r0 * W), u[r0:r1])
    with pytest.raises(ValueError, match="lane_base"):
        FC.counter_advance(state, budget, *_luts(grid), 1, lane_base=-1)


def _batches():
    rng = np.random.default_rng(7)
    keys = [rng.zipf(1.3, size=4096).astype(np.int64) % 50_000
            for _ in range(4)]
    cons = [rng.integers(0, 3000, size=2048) for _ in range(2)]
    return keys, cons


def test_row_sharded_sketch_equals_unsharded():
    keys, cons = _batches()
    got = D.spawn(D.sketch_run, 2, SK, keys, cons)
    ref = F2PSketch(SketchConfig(**SK), device=CPU)
    for i, k in enumerate(keys):
        ref.update(torch.from_numpy(k) if i % 2 else k)
    pending = ref.pending_budget
    probe = np.arange(64)
    before = (ref.query(probe), ref.fill())
    ref.flush()
    rcons = F2PSketch(SketchConfig(**dict(SK, conservative=True)),
                      device=CPU)
    for k in cons:
        rcons.update(k)
    assert pending > 0
    for rank, res in enumerate(got):
        assert res["rows"] == (SK["depth"] // 2, SK["width"])
        np.testing.assert_array_equal(res["state"], ref.state.numpy())
        np.testing.assert_array_equal(res["estimates"], ref.estimates())
        np.testing.assert_array_equal(res["query"], ref.query(probe))
        np.testing.assert_array_equal(res["before"][0], before[0])
        assert res["before"][1] == before[1]
        assert res["fill"] == ref.fill()
        assert res["pending"] == pending
        assert res["pending_after"] == ref.pending_budget == 0.0
        assert res["arrivals"] == ref.arrivals
        np.testing.assert_array_equal(res["conservative"], rcons.estimates())


def test_maybe_shard_places_lanes_in_runs(monkeypatch):
    lanes = [{"x": torch.full((2,), float(i))} for i in range(8)]
    cfg = R.FleetConfig(client_batch=8)
    # no card here: the local devices are none, the tree passes
    assert R._local_devices() == [] and R._maybe_shard(lanes, cfg) is lanes
    for devices, placed in (([CPU, "meta"], True), ([CPU], False),
                            ([CPU] * 3, False)):
        monkeypatch.setattr(R, "_local_devices", lambda: devices)
        out = R._maybe_shard(lanes, cfg)
        if placed:
            assert [t["x"].device.type for t in out] == \
                ["cpu"] * 4 + ["meta"] * 4
        else:
            assert out is lanes
    off = R.FleetConfig(client_batch=8, shard_clients=False)
    assert R._maybe_shard(lanes, off) is lanes


@pytest.mark.parametrize("n", [2, 4])
def test_fleet_bits_do_not_depend_on_the_split(monkeypatch, n):
    ccfg = ClientConfig(local_steps=1, scale_mode="pow2",
                        error_feedback=True, packed=True, min_size=512)
    flcfg = R.FleetConfig(n_clients=40, sample=12, quorum=6, rounds=2,
                          client=ccfg, client_batch=8)
    want = R.run_fleet_rounds(flcfg, device=CPU)
    monkeypatch.setattr(R, "_local_devices",
                        lambda: [torch.device(CPU)] * n)
    got = R.run_fleet_rounds(flcfg, device=CPU)
    assert got["eval_loss"] == want["eval_loss"]
    assert got["wire_bytes_per_round"] == want["wire_bytes_per_round"]
    for a, b in zip(_tree.leaves(got["params"]),
                    _tree.leaves(want["params"])):
        assert torch.equal(a, b)
