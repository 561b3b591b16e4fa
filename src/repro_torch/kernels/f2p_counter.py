"""Batched probabilistic increments of F2P grid counters: the advance and
estimate kernels, their plain versions and the uniform stream they share.

Port of ``repro.kernels.f2p_counter`` (DESIGN.md §6). A flat array of
N-bit registers over a shared monotone estimate grid ``L[0..K-1]`` advances
from state ``k`` to ``k+1`` with probability ``p_k = 1/(L[k+1]-L[k])`` per
arrival, so the expected estimate grows by exactly 1 per arrival.

``counter_advance`` replaces the TPU kernel
``repro/kernels/f2p_counter.py::_advance_kernel`` (B9). It consumes a
per-cell arrival *budget* by the sequential stochastic process in a fixed
number of sweeps (``PALLAS_SWEEPS``); each sweep crosses the run of p = 1
states in one step (``advance_tables``), draws the geometric sojourn of the
current state by inverse CDF, and advances while the budget covers it.
Budget a cell cannot spend within the sweeps comes back as ``leftover``.

The one change of form: the TPU kernel streams ``[rows, sweeps, width]``
uniforms pre-drawn with threefry (256 MiB per call at 4 x 2^20 cells). The
CUDA kernel computes each uniform in registers from the reference's own
counter-based stream, ``u = hash(seed, sweep, lane)`` with ``lane`` the
flat cell index (the stream the reference's xla backend draws, and the slot
DESIGN.md §6.3 reserves for a hardware PRNG). The plain version keeps the
TPU kernel's signature — explicit uniforms — and :func:`hash_uniforms`
builds them, so kernel and plain version are bitwise equal on the same
``(seed, sweep0)``. On an H100 the kernel is bound by bytes: it reads state
and budget and writes state and leftover, 16 B per cell; the three LUTs
(at most 768 KiB at 16 bits) stay in the 50 MB L2 and are read through the
read-only cache. One thread per cell, and a cell whose budget is spent
stops early: with ``rem == 0`` a sweep leaves ``(state, rem)`` unchanged,
so stopping keeps the equality.

``counter_estimate`` replaces ``_estimate_kernel`` (B10): ``L[state]``,
one thread per cell, bound by bytes (8 B per cell).

Each wrapper routes by the tensor's device: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel of ``csrc/f2p_kernels.cu`` or
raises. Budget arithmetic is float32, exact for integer budgets below
``MAX_EXACT_BUDGET``.

The sojourn goes through an f32 ``log``. The kernel uses ``logf`` (not
``__logf``) and a correctly rounded divide, the arithmetic of ``torch.log``
and ``/`` on the card, so the two agree bitwise there. Against JAX on the
CPU the two ``log`` implementations differ by one ulp on some inputs, which
can flip ``ceil(log u / log q)`` in a few draws in a million: parity with
the reference is held to a stated fraction of cells (ROADMAP C3).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import cuda as C
from repro_torch.kernels.bits import fmix32
from repro_torch.kernels.cost import charged

__all__ = ["advance_tables", "hash_uniforms", "counter_advance_plain",
           "counter_advance", "counter_advance_exact",
           "counter_estimate_plain", "counter_estimate",
           "MAX_EXACT_BUDGET", "PALLAS_SWEEPS"]

# f32 integer-exactness ceiling for per-cell budgets.
MAX_EXACT_BUDGET = 1 << 24

# Sweeps per advance call (the TPU kernel's fixed trip count). Leftover
# budget is returned, never dropped.
PALLAS_SWEEPS = 16

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1


# ---------------------------------------------------------------------------
# Grid -> advance tables (a copy of the reference's numpy)
# ---------------------------------------------------------------------------
def advance_tables(grid: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(p, unit_run, log_q) driving the advance process, length-K float32.

    ``p[k]``        advance probability out of state k (``p[K-1] = 0``: the
                    top state saturates).
    ``unit_run[k]`` length of the maximal run of consecutive states starting
                    at k with ``p == 1`` — the deterministic region a single
                    vector step can cross.
    ``log_q[k]``    ``log(1 - p[k])`` — the geometric inverse-CDF denominator
                    as a gather instead of a per-element transcendental
                    (0 where p is 0 or 1; both are special-cased).
    """
    g = np.asarray(grid, dtype=np.float64)
    gaps = np.diff(g)
    if np.any(gaps <= 0):
        raise ValueError("grid must be strictly increasing")
    K = len(g)
    p = np.zeros(K, dtype=np.float64)
    p[:-1] = np.minimum(1.0 / gaps, 1.0)
    unit = p == 1.0
    run = np.zeros(K, dtype=np.int64)
    for k in range(K - 2, -1, -1):
        run[k] = run[k + 1] + 1 if unit[k] else 0
    with np.errstate(divide="ignore"):
        log_q = np.where((p > 0) & (p < 1), np.log1p(-p), 0.0)
    return (p.astype(np.float32), run.astype(np.float32),
            log_q.astype(np.float32))


# ---------------------------------------------------------------------------
# The uniform stream
# ---------------------------------------------------------------------------
def _hash_uniform(seed: int, sweep: int, lanes: torch.Tensor) -> torch.Tensor:
    """Counter-based uniforms on (0, 1): the murmur3 finalizer of
    ``lane ^ (sweep * 0x9E3779B1) ^ seed`` in uint32 arithmetic, its top 24
    bits offset by half an ulp (every step exact in f32)."""
    salt = ((int(sweep) * _GOLDEN) ^ int(seed)) & _M32
    x = fmix32(lanes ^ salt)
    return ((x >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)


def hash_uniforms(seed: int, sweep0: int, sweeps: int, shape,
                  device="cpu", lane_base: int = 0) -> torch.Tensor:
    """The uniforms the kernel draws for sweeps ``sweep0 .. sweep0+sweeps-1``
    of a state array of ``shape``, laid out as the TPU kernel takes them:
    ``[..., sweeps, width]`` (``[rows, sweeps, width]`` for 2-D state).
    ``lane`` is ``lane_base`` plus the flat (row-major) cell index: a row
    shard starting at global cell ``lane_base`` draws the whole state's
    stream for its cells."""
    shape = tuple(shape)
    n = math.prod(shape)
    lanes = torch.arange(int(lane_base), int(lane_base) + n,
                         dtype=torch.int64, device=device).reshape(shape)
    return torch.stack([_hash_uniform(seed, sweep0 + t, lanes)
                        for t in range(int(sweeps))], dim=-2)


# ---------------------------------------------------------------------------
# counter_advance (B9)
# ---------------------------------------------------------------------------
def _sojourn(u, p, log_q):
    """Geometric sojourn by inverse CDF: T = ceil(log u / log(1-p)).
    ``p == 1`` -> exactly 1; ``p == 0`` (saturated top) -> +inf so the cell
    parks. The overrides come before the maximum, as in the reference."""
    t = torch.ceil(torch.log(u) / log_q)
    t = torch.where(p >= 1.0, 1.0, t)
    t = torch.where(p <= 0.0, math.inf, t)
    return torch.clamp_min(t, 1.0)


def _sweep(state, rem, u, p_lut, run_lut, logq_lut, kmax: int):
    """One vector step: cross the unit run, then one geometric sojourn."""
    run = torch.minimum(rem, run_lut[state.long()])
    state = state + run.to(torch.int32)
    rem = rem - run
    idx = state.long()
    need = _sojourn(u, p_lut[idx], logq_lut[idx])
    adv = need <= rem
    state = torch.where(adv, torch.clamp_max(state + 1, kmax), state)
    # a sojourn past the budget means no advance within this batch (the
    # memoryless geometric makes dropping the partial progress exact); a
    # saturated cell (need = inf) parks the same way
    rem = torch.where(adv, rem - need, 0.0)
    return state, rem


def counter_advance_plain(state: torch.Tensor, budget: torch.Tensor,
                          p_lut: torch.Tensor, run_lut: torch.Tensor,
                          logq_lut: torch.Tensor,
                          u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's computation on explicit uniforms ``u`` of shape
    ``[..., sweeps, width]`` (:func:`hash_uniforms`): returns the int32
    state and the f32 leftover budget after ``u.shape[-2]`` sweeps."""
    kmax = int(p_lut.shape[0]) - 1
    st = state.to(torch.int32)
    rem = budget.to(torch.float32)
    for t in range(u.shape[-2]):
        st, rem = _sweep(st, rem, u.select(-2, t), p_lut, run_lut,
                         logq_lut, kmax)
    return st, rem


def _check_advance_args(state, budget, luts) -> None:
    if state.shape != budget.shape:
        raise ValueError(f"state {tuple(state.shape)} and budget "
                         f"{tuple(budget.shape)} differ in shape")
    K = luts[0].shape[0]
    for t in luts:
        if t.ndim != 1 or t.shape[0] != K:
            raise ValueError("p, run and logq must be 1-D tables of one "
                             "length")
    if K < 2:
        raise ValueError("a grid needs at least two states")


@charged("counter_advance")
def counter_advance(state: torch.Tensor, budget: torch.Tensor,
                    p_lut: torch.Tensor, run_lut: torch.Tensor,
                    logq_lut: torch.Tensor, seed: int, *, sweep0: int = 0,
                    sweeps: int = PALLAS_SWEEPS, lane_base: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``sweeps`` sweeps of the stochastic advance from sweep ``sweep0`` of
    the stream seeded by ``seed`` (a uint32). Returns ``(state,
    leftover)``. A CPU tensor runs :func:`counter_advance_plain` on
    :func:`hash_uniforms`; a CUDA tensor launches ``counter_advance_kernel``.
    ``state`` must lie in ``[0, K)`` and ``budget`` be finite and >= 0.
    ``lane_base``: the global index of ``state``'s first cell, where
    ``state`` is a row shard of a larger state (the sharded sketch)."""
    luts = (p_lut, run_lut, logq_lut)
    _check_advance_args(state, budget, luts)
    seed, sweep0, sweeps = int(seed) & _M32, int(sweep0), int(sweeps)
    lane_base = int(lane_base)
    if lane_base < 0:
        raise ValueError(f"lane_base must be >= 0, got {lane_base}")
    if state.device.type == "cpu":
        u = hash_uniforms(seed, sweep0, sweeps, state.shape,
                          lane_base=lane_base)
        return counter_advance_plain(state, budget, *luts, u)
    C.require_cuda(state, "state", torch.int32)
    C.require_cuda(budget, "budget", torch.float32)
    for name, t in zip(("p", "run", "logq"), luts):
        C.require_cuda(t, name, torch.float32)
    if not 0 <= sweep0 <= _M32:
        raise ValueError(f"sweep0 must be a uint32, got {sweep0}")
    out_state = torch.empty_like(state)
    left = torch.empty_like(budget)
    C.check(C.lib().f2p_counter_advance(
        state.data_ptr(), budget.data_ptr(), out_state.data_ptr(),
        left.data_ptr(), p_lut.data_ptr(), run_lut.data_ptr(),
        logq_lut.data_ptr(), state.numel(), int(p_lut.shape[0]) - 1, seed,
        sweep0, sweeps, lane_base, C.stream()), "counter_advance")
    C.LAUNCHES["counter_advance"] += 1
    return out_state, left


def counter_advance_exact(state: torch.Tensor, budget: torch.Tensor,
                          p_lut: torch.Tensor, run_lut: torch.Tensor,
                          logq_lut: torch.Tensor, seed: int, *,
                          lane_base: int = 0
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance until every budget is spent: :func:`counter_advance` calls
    of ``PALLAS_SWEEPS`` sweeps on one stream, ``sweep0`` stepping by
    ``PALLAS_SWEEPS``, one host sync per call. This follows the stream of
    the reference's exact ``counter_advance_xla`` given the same uint32
    ``seed``. Every sweep spends at least one arrival or parks the cell, so
    the loop ends; the leftover returned is zero."""
    rem = budget
    sweep0 = 0
    while True:
        state, rem = counter_advance(state, rem, p_lut, run_lut, logq_lut,
                                     seed, sweep0=sweep0, lane_base=lane_base)
        sweep0 += PALLAS_SWEEPS
        if not bool((rem > 0).any()):
            return state, rem


# ---------------------------------------------------------------------------
# counter_estimate (B10)
# ---------------------------------------------------------------------------
def counter_estimate_plain(state: torch.Tensor,
                           grid_lut: torch.Tensor) -> torch.Tensor:
    """Estimates ``L[state]``: a gather through the f32 grid."""
    return grid_lut[state.long()]


@charged("counter_estimate")
def counter_estimate(state: torch.Tensor, grid_lut: torch.Tensor) -> torch.Tensor:
    """``L[state]``: the plain gather for a CPU tensor,
    ``counter_estimate_kernel`` for a CUDA tensor (state in ``[0, K)``)."""
    if grid_lut.ndim != 1:
        raise ValueError("grid_lut must be 1-D")
    if state.device.type == "cpu":
        return counter_estimate_plain(state, grid_lut)
    C.require_cuda(state, "state", torch.int32)
    C.require_cuda(grid_lut, "grid_lut", torch.float32)
    out = torch.empty(state.shape, dtype=torch.float32, device=state.device)
    C.check(C.lib().f2p_counter_estimate(
        state.data_ptr(), grid_lut.data_ptr(), out.data_ptr(), state.numel(),
        C.stream()), "counter_estimate")
    C.LAUNCHES["counter_estimate"] += 1
    return out
