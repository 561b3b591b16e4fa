"""Batched count-min sketch over F2P grid-counter cells (DESIGN.md §6).

Port of ``repro.sketch.sketch``. One ``(depth, width)`` int32 tensor of
register *states* indexes a shared monotone estimate grid — for F2P cells
the format's ``payload_grid``, so a 16-bit F2P_LI^2 cell counts to ~33.5M.
Per batch the update is

    hash rows -> add arrival budgets into the carry -> stochastic advance

and the advance is ``kernels.f2p_counter.counter_advance``: the CUDA kernel
(B9) for a sketch on the card, its plain version for one on the CPU. It
runs a fixed number of sweeps, so budget a cell could not spend is
*carried* into the next batch; :meth:`F2PSketch.flush` drains it.

Collision semantics: aggregating a batch's arrivals into per-cell budgets
*before* advancing makes the update exact-in-distribution for the
sequential on-arrival process.

Each advance call draws a fresh uint32 seed from the sketch's own numpy
generator (``default_rng(cfg.seed)``), so a sketch's trajectory depends on
its seed and its inputs only, on either device.

Row sharding: with a 1-D ``mesh`` (``launch.mesh.make_sketch_mesh``, axis
``"rows"``; its size divides ``depth``) each rank holds ``depth / n``
consecutive rows of ``state`` and of the carry. Every rank sees every
batch and hashes it for its own rows only; the advance runs on the row
shard with its first cell's global index as the uniform stream's lane
base, so the shards together are bitwise the unsharded sketch. ``query``,
``estimates``, ``fill`` and ``pending_budget`` gather over the rows axis.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import f2p_counter as FC
from repro_torch.sketch.hashing import hash_rows, hash_rows_np, make_hash_params

__all__ = ["SketchConfig", "F2PSketch", "choose_grid"]


def choose_grid(max_count: float, target_range: float | None = None, *,
                n_bits_options=(8, 12, 16), h_bits_options=(1, 2, 3),
                flavors=("li", "si")):
    """Pick the cheapest F2P counter format that reaches ``max_count``,
    minimizing the modeled counting error over ``[0, target_range]``.

    Among all (flavor, h_bits) partitions at the smallest viable register
    width, the closed-form error model (counts uniform on the target range)
    scores the grids and the flattest one over the range wins. Returns
    ``(fmt, grid)``. ``target_range`` defaults to ``max_count``."""
    from repro_torch.autotune.error_models import UniformDist, expected_mse
    from repro_torch.core.f2p import F2PFormat, Flavor

    if max_count <= 0:
        raise ValueError(f"max_count must be positive, got {max_count}")
    rng_hi = float(target_range if target_range is not None else max_count)
    rng_hi = min(rng_hi, float(max_count))
    dist = UniformDist(0.0, rng_hi)

    for n in sorted(n_bits_options):
        best = None
        for h in h_bits_options:
            for fl in flavors:
                try:
                    fmt = F2PFormat(n_bits=n, h_bits=h, flavor=Flavor(fl))
                except ValueError:
                    continue
                grid = fmt.payload_grid
                if grid[-1] < max_count:
                    continue
                err = expected_mse(fmt, dist)
                if best is None or err < best[0]:
                    best = (err, fmt, grid)
        if best is not None:
            return best[1], best[2]
    raise ValueError(
        f"no candidate reaches max_count={max_count:g}; widest grid tops at "
        "less — raise n_bits_options")


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """Count-min geometry + cell format + update policy. The reference's
    ``backend`` field has no counterpart: the sketch's device decides."""

    depth: int = 4            # hash rows (error probability ~ e^-depth)
    width: int = 4096         # cells per row
    n_bits: int = 8           # F2P register width
    h_bits: int = 2
    flavor: str = "li"        # F2P flavor of the cell grid
    conservative: bool = False  # batched conservative update (top-up form)
    seed: int = 0

    @classmethod
    def for_requirements(cls, max_count: float,
                         target_range: float | None = None,
                         **kw) -> "SketchConfig":
        """SketchConfig whose cell format ``choose_grid`` picked for the
        workload's (max_count, target_range). Other fields pass through."""
        fmt, _ = choose_grid(max_count, target_range)
        return cls(n_bits=fmt.n_bits, h_bits=fmt.h_bits,
                   flavor=fmt.flavor.value, **kw)


class F2PSketch:
    """Count-min sketch with F2P grid-counter cells and batched updates on
    ``device`` (the card by default).

    ``update`` consumes a batch of integer flow keys (plus optional per-key
    arrival counts); ``query`` returns count-min estimates (min over rows).
    Unspent budget is carried into the next batch; ``pending_budget``
    exposes the carry and ``flush`` drains it.
    """

    def __init__(self, cfg: SketchConfig, grid: np.ndarray | None = None,
                 device="cuda", mesh=None):
        self.cfg = cfg
        self.mesh, self._group, self._row0, rows = None, None, 0, cfg.depth
        if mesh is not None:
            if not hasattr(mesh, "mesh_dim_names") or mesh.ndim != 1:
                raise TypeError("mesh must be a 1-D DeviceMesh "
                                "(launch.mesh.make_sketch_mesh)")
            n = mesh.size(0)
            if cfg.depth % n:
                raise ValueError(f"depth {cfg.depth} does not split over "
                                 f"{n} ranks of {mesh.mesh_dim_names[0]!r}")
            rows = cfg.depth // n
            self.mesh, self._group = mesh, mesh.get_group(0)
            self._row0 = mesh.get_coordinate()[0] * rows
        self.device = torch.device(device)
        if grid is None:
            from repro_torch.core.f2p import F2PFormat, Flavor

            grid = F2PFormat(n_bits=cfg.n_bits, h_bits=cfg.h_bits,
                             flavor=Flavor(cfg.flavor)).payload_grid
        self.grid = np.asarray(grid, dtype=np.float64)
        dev = self.device
        p, run, logq = FC.advance_tables(self.grid)
        self._grid_lut = torch.tensor(self.grid, dtype=torch.float32,
                                      device=dev)
        self._p_lut = torch.from_numpy(p).to(dev)
        self._run_lut = torch.from_numpy(run).to(dev)
        self._logq_lut = torch.from_numpy(logq).to(dev)
        a, b = make_hash_params(cfg.depth, seed=cfg.seed)
        a, b = a[self._row0:self._row0 + rows], b[self._row0:self._row0 + rows]
        self._a_np, self._b_np = a, b
        self._a = torch.from_numpy(a.astype(np.int64)).to(dev)
        self._b = torch.from_numpy(b.astype(np.int64)).to(dev)
        self._rows = torch.arange(rows, device=dev)[:, None]
        shape = (rows, cfg.width)
        self.state = torch.zeros(shape, dtype=torch.int32, device=dev)
        self._carry = torch.zeros(shape, dtype=torch.float32, device=dev)
        # ingest accounting: host batches tally synchronously; device
        # batches park their per-batch totals here (no sync), summed in
        # f64 on the host when `arrivals` is read
        self._arrivals_host = 0.0
        self._arrivals_dev_pending: list[torch.Tensor] = []
        self._rng = np.random.default_rng(cfg.seed)

    @classmethod
    def from_state(cls, cfg: SketchConfig, state: np.ndarray,
                   carry: np.ndarray | None = None,
                   grid: np.ndarray | None = None,
                   device="cuda") -> "F2PSketch":
        """A sketch holding ``state`` (and ``carry``) — numpy arrays, e.g.
        ``np.asarray`` of a reference sketch's fields. The hash constants
        come from ``cfg.seed`` as in the reference, so both answer the same
        queries."""
        sk = cls(cfg, grid=grid, device=device)
        shape = (cfg.depth, cfg.width)
        st = np.asarray(state)
        if st.shape != shape:
            raise ValueError(f"state {st.shape} does not match {shape}")
        sk.state = torch.from_numpy(st.astype(np.int32)).to(sk.device)
        if carry is not None:
            sk._carry = torch.from_numpy(
                np.array(carry, np.float32).reshape(shape)).to(sk.device)
        return sk

    # ---- advance ----------------------------------------------------------
    def _next_seed(self) -> int:
        return int(self._rng.integers(0, 1 << 32, dtype=np.uint64))

    def _advance(self, budget: torch.Tensor) -> None:
        self.state, self._carry = FC.counter_advance(
            self.state, budget, self._p_lut, self._run_lut, self._logq_lut,
            self._next_seed(), lane_base=self._row0 * self.cfg.width)

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The whole ``(depth, ...)`` tensor of a row-sharded one."""
        if self.mesh is None:
            return t
        from repro_torch.launch import mesh as M

        return M.all_gather(t, self._group, leg="sketch.rows_all_gather")

    # ---- host aggregation fast path ---------------------------------------
    def _host_budget(self, keys: np.ndarray, counts: np.ndarray) -> np.ndarray:
        """Arrival batch -> (depth, width) budget in numpy: pre-combine
        duplicate keys, then per-row hash + bincount (the reference's host
        path, bit-identical cell placement through ``hash_rows_np``)."""
        cfg = self.cfg
        kmin = int(keys.min()) if keys.size else 0
        kmax = int(keys.max()) if keys.size else 0
        if kmin >= 0 and kmax < 4 * keys.size:  # dense keys -> one bincount
            per_key = np.bincount(keys, weights=counts)
            uniq = np.nonzero(per_key)[0]
            ucnt = per_key[uniq]
        else:
            uniq, inv = np.unique(keys, return_inverse=True)
            ucnt = np.bincount(inv, weights=counts)
        idx = hash_rows_np(uniq, self._a_np, self._b_np, cfg.width)
        rows = len(self._a_np)
        if cfg.conservative:
            # "top-up to target" conservative update: each row's cell is
            # raised to (min over rows of the current estimates) + count
            host_state = self.state.cpu().numpy()
            est = self.grid[host_state[np.arange(rows)[:, None], idx]]
            emin = est.min(axis=0, keepdims=True)
            if self.mesh is not None:
                emin = self._gather_rows(torch.from_numpy(emin).to(
                    self.device)).min(dim=0, keepdim=True).values
                emin = emin.cpu().numpy()
            target = emin + ucnt[None, :]
            w_rows = np.clip(target - est, 0.0, ucnt[None, :])
        budget = np.empty((rows, cfg.width), np.float32)
        for d in range(rows):
            w = w_rows[d] if cfg.conservative else ucnt
            budget[d] = np.bincount(idx[d], weights=w, minlength=cfg.width)
        return budget

    # ---- public API -------------------------------------------------------
    def update(self, keys, counts=None) -> None:
        """Ingest one batch of arrivals: ``keys[i]`` saw ``counts[i]``
        (default 1) packet arrivals. Zero-count keys are legal padding.

        numpy batches aggregate on the host and ship one budget array;
        tensor batches stay on their device end to end: hash, scatter-add
        into the carry, advance, with the arrival total parked un-synced.
        Conservative updates always take the host path (the top-up rule
        needs per-key batch counts)."""
        host = self.cfg.conservative or not isinstance(keys, torch.Tensor)
        if host:
            keys = (keys.cpu().numpy() if isinstance(keys, torch.Tensor)
                    else np.asarray(keys))
            counts = (np.ones(len(keys), np.float32) if counts is None
                      else (counts.cpu().numpy()
                            if isinstance(counts, torch.Tensor)
                            else np.asarray(counts)))
            total = float(counts.sum())
            if total > FC.MAX_EXACT_BUDGET:
                raise ValueError(
                    f"batch of {total:.0f} arrivals exceeds the f32-exact "
                    f"budget ceiling ({FC.MAX_EXACT_BUDGET}); split the batch")
            if self.cfg.conservative and self.pending_budget > 0:
                # top-up targets come from current estimates; carried budget
                # would understate them — drain first
                self.flush()
            budget = torch.from_numpy(self._host_budget(keys, counts))
            self._advance(budget.to(self.device) + self._carry)
            self._arrivals_host += total
            return
        keys = keys.to(self.device)
        if counts is None:
            counts = torch.ones(keys.shape, dtype=torch.float32,
                                device=self.device)
            total_bound = float(keys.numel())
        else:
            counts = torch.as_tensor(counts, device=self.device).to(
                torch.float32)
            total_bound = float(counts.sum())
        # The scatter adds integer counts with float atomics, which reorder
        # the adds; below 2^24 per cell every partial sum is an exact f32
        # integer, so the total is exact and deterministic.
        if total_bound > FC.MAX_EXACT_BUDGET:
            raise ValueError(
                f"batch of {total_bound:.0f} arrivals exceeds the f32-exact "
                f"budget ceiling ({FC.MAX_EXACT_BUDGET}); split the batch")
        idx = hash_rows(keys, self._a, self._b, self.cfg.width).long()
        budget = self._carry.clone()
        budget.index_put_(
            (self._rows.expand_as(idx), idx),
            counts.reshape(1, -1).expand(idx.shape[0], -1),
            accumulate=True)
        self._advance(budget)
        self._arrivals_dev_pending.append(counts.sum(dtype=torch.float32))

    def query(self, keys) -> np.ndarray:
        """Count-min estimates for ``keys`` (min over rows of L[state])."""
        keys = (keys.to(self.device) if isinstance(keys, torch.Tensor)
                else torch.from_numpy(np.asarray(keys).astype(np.int64))
                .to(self.device))
        idx = hash_rows(keys, self._a, self._b, self.cfg.width).long()
        est = self._grid_lut[self.state[self._rows, idx].long()]
        est = est.min(dim=0, keepdim=True).values
        return self._gather_rows(est).min(dim=0).values.cpu().numpy()

    def estimates(self) -> np.ndarray:
        """Full (depth, width) estimate table through ``counter_estimate``
        (the B10 kernel on the card; on each row shard, then gathered)."""
        return self._gather_rows(
            FC.counter_estimate(self.state, self._grid_lut)).cpu().numpy()

    def flush(self) -> float:
        """Drain the carried budget with ``counter_advance_exact`` (one
        stream, ``PALLAS_SWEEPS`` sweeps per launch, until every cell's
        budget is spent); returns the budget still pending, 0. The
        reference stops after 64 rounds of 16 sweeps; a heavy cell of a
        16-bit sketch needs tens of thousands of sweeps, so the port drains
        to the end (ROADMAP C4)."""
        if not self.pending_budget > 0:
            return 0.0
        self.state, self._carry = FC.counter_advance_exact(
            self.state, self._carry, self._p_lut, self._run_lut,
            self._logq_lut, self._next_seed(),
            lane_base=self._row0 * self.cfg.width)
        return self.pending_budget

    @property
    def arrivals(self) -> float:
        """Exact total arrivals ingested (syncs the device tally on read)."""
        if self._arrivals_dev_pending:
            self._arrivals_host += sum(float(x)
                                       for x in self._arrivals_dev_pending)
            self._arrivals_dev_pending = []
        return self._arrivals_host

    @property
    def pending_budget(self) -> float:
        """Total arrival budget carried to the next batch (f64 sum; the
        carries are whole numbers, so the shards' sum is exact)."""
        total = self._carry.sum(dtype=torch.float64)
        if self.mesh is not None:
            from repro_torch.launch import mesh as M

            M.all_reduce(total.reshape(1), self._group,
                         leg="sketch.budget_all_reduce")
        return float(total)

    @property
    def nbytes(self) -> int:
        """Register bytes at the configured width (what a hardware deploy
        would hold; the device mirror is int32 for gather friendliness)."""
        return self.cfg.depth * self.cfg.width * ((self.cfg.n_bits + 7) // 8)

    def fill(self) -> float:
        """Fraction of non-zero cells (collision-pressure diagnostic)."""
        if self.mesh is None:
            return float((self.state > 0).float().mean())
        from repro_torch.launch import mesh as M

        n = (self.state > 0).sum().to(torch.float64).reshape(1)
        M.all_reduce(n, self._group, leg="sketch.fill_all_reduce")
        return float(np.float32(float(n) / (self.cfg.depth * self.cfg.width)))

    def __repr__(self) -> str:
        return (f"F2PSketch(depth={self.cfg.depth}, width={self.cfg.width}, "
                f"F2P_{self.cfg.flavor.upper()}^{self.cfg.h_bits}"
                f"[{self.cfg.n_bits}], device={self.device}, "
                f"arrivals={self.arrivals:.0f})")
