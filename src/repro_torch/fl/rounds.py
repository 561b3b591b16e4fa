"""Fed-avg rounds driver: the end-to-end FL simulator (port of
``repro.fl.rounds``).

Wires the toy LM (``repro_torch.models``) + deterministic synthetic data
(``repro_torch.data``) into client/server rounds. Each client sees a
disjoint deterministic batch stream (shard-by-client of the step-indexed
pipeline), runs ``local_steps`` SGD steps, and ships its delta as an
(optionally F2P-quantized) update; the server aggregates and applies.

``run_fed_avg`` is what ``examples/fed_avg.py`` drives in the reference;
the baseline is the same driver with ``compress=False`` (f32 deltas on the
wire). With ``FedAvgConfig.autotune`` set, the server folds every
aggregated delta into streaming histograms (``autotune.calibrate``) and
every K rounds re-solves a per-leaf :class:`FormatPolicy` under the fixed
config's bit budget; a policy change replaces the client config.

``run_fleet_rounds`` is the straggler-tolerant fleet under a
:class:`~repro_torch.faults.FaultPlan`, folded by the exact integer
aggregator. Where the reference vmaps the client over a chunk of
``client_batch`` clients, the port runs the chunk's clients one after the
other on the device (each quantize a kernel launch) and copies the chunk's
updates to the host in one transfer; the chunk width cannot change a bit.
With several cards and ``FleetConfig.shard_clients`` a chunk's lanes are
spread over the cards (``_maybe_shard``: lane ``j`` of a chunk on card
``j // (client_batch / n)``), each card with its own replica of the
round's parameters; a lane's bits cannot depend on the card it ran on.

Parameters are the reference's tree (``models.convert.stacked_params``);
the drivers run on ``device`` (default ``"cuda"``, as ``init_params``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.fl import _tree
from repro_torch.fl import client as C
from repro_torch.fl import server as S

# module-scoped registries (created lazily, reset per run) so obs.export()
# still sees the last run's numbers after the driver returns
_REGS: dict[str, obs.MetricsRegistry] = {}


def _registry(name: str, seed: int) -> obs.MetricsRegistry:
    reg = _REGS.get(name)
    if reg is None:
        reg = obs.MetricsRegistry(name, seed=seed)
        _REGS[name] = reg
    reg.reset()
    return reg


@dataclasses.dataclass(frozen=True)
class AutotuneConfig:
    """Re-solve the per-leaf delta format every ``every`` rounds.

    ``n_bits`` defaults to the fixed format's width only: every candidate
    then stores codes in the same dtype, so re-solving never changes wire
    bytes, only where the representable points sit. Budgets beyond that
    are opt-in via ``n_bits``."""

    every: int = 2
    n_bits: tuple[int, ...] = (8,)
    h_bits: tuple[int, ...] = (1, 2, 3)
    budget_bits_per_elem: float | None = None  # None: match fixed config


@dataclasses.dataclass(frozen=True)
class FedAvgConfig:
    n_clients: int = 4
    rounds: int = 5
    client: C.ClientConfig = C.ClientConfig()
    server_lr: float = 1.0
    seed: int = 0
    autotune: Any = None   # AutotuneConfig | None


def toy_task(*, d_model: int = 64, n_layers: int = 2, vocab: int = 512,
             seq_len: int = 32, batch: int = 8):
    """(model_cfg, data_cfg, loss_fn, init_params_fn) for the toy LM, the
    reference's FL substrate: llama-dense, 4 heads over 2 KV heads, d_ff =
    2 d_model, f32, no remat.

    ``loss_fn(params, batch)`` is ``models.train_forward``'s loss over a
    parameter tree (per-layer views of each stacked leaf stand in for the
    port's per-layer parameters, so the gradient lands on the stacked
    leaf); ``init_params_fn(cfg, seed, device)`` the port's seeded init as
    that tree."""
    from repro_torch.data import DataConfig
    from repro_torch.models import init_params
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.convert import stacked_params

    cfg = ModelConfig(name="fl-toy", n_layers=n_layers, d_model=d_model,
                      n_heads=4, n_kv_heads=2, d_ff=2 * d_model,
                      vocab_size=vocab, dtype="float32", remat=False)
    dcfg = DataConfig(vocab_size=vocab, seq_len=seq_len, global_batch=batch)

    def init_params_fn(cfg_, seed: int, device):
        return stacked_params(init_params(cfg_, seed, device))

    return cfg, dcfg, _tree_loss_fn(cfg), init_params_fn


class _Loss(torch.nn.Module):
    def __init__(self, cfg):
        from repro_torch.models.model import Model

        super().__init__()
        self.cfg = cfg
        self.model = Model(cfg, "meta")   # names only: no storage

    def forward(self, batch):
        from repro_torch.models import train_forward

        return train_forward(self.model, batch, self.cfg)[0]


def _tree_loss_fn(cfg):
    """``loss(params, batch)``: the train loss of ``cfg`` over a
    parameter tree in the reference's layout."""
    from repro_torch.models.convert import reference_path

    mod = _Loss(cfg)
    names = [(f"model.{n}", *reference_path(n, len(cfg.pattern)))
             for n, _ in mod.model.named_parameters()]

    def loss_fn(params, batch):
        views = {}
        for name, path, layer in names:
            leaf = _tree.get_path(params, path)
            views[name] = leaf if layer is None else leaf[layer]
        return torch.func.functional_call(mod, views, (batch,))

    return loss_fn


def _client_stream(dcfg, local_steps: int, round_i: int, client_id: int,
                   device="cpu"):
    """Stacked [local_steps] batch dict for one client round (int32
    tensors on ``device``).

    The stream base depends ONLY on (client_id, round), never on loop
    position or fleet size, so dropping, resampling, or reordering clients
    cannot shift any other client's data. Client bases sit at ``(id+1) *
    2^20``: disjoint per client for < 2^20 round-steps, and far above the
    held-out eval batch index 1_000_003 < 2^20."""
    from repro_torch.data import global_batch

    idx0 = (client_id + 1) * (1 << 20) + round_i * local_steps
    bs = [global_batch(dcfg, idx0 + s) for s in range(local_steps)]
    return {k: torch.from_numpy(np.stack([b[k] for b in bs])).to(device)
            for k in bs[0]}


def _client_batches(dcfg, fcfg: FedAvgConfig, round_i: int, client_i: int,
                    device="cpu"):
    """:func:`_client_stream` at ``fcfg.client.local_steps`` (the
    reference's helper of the same name)."""
    return _client_stream(dcfg, fcfg.client.local_steps, round_i, client_i,
                          device)


def _eval_batch(dcfg, device):
    from repro_torch.data import global_batch

    return {k: torch.from_numpy(v).to(device)
            for k, v in global_batch(dcfg, 1_000_003).items()}


def _solve_policy(calib: dict, meta: dict, fcfg: FedAvgConfig):
    """Calibrated histograms -> per-leaf FormatPolicy at the fixed config's
    bit budget. Returns None when nothing has calibrated yet."""
    from repro_torch.autotune import calibrate as CAL
    from repro_torch.autotune import policy as P
    from repro_torch.core.formats import format_name

    atcfg, ccfg = fcfg.autotune, fcfg.client
    leaves = []
    for path, (size, last_dim) in meta.items():
        if path not in calib:
            continue
        try:
            dist = CAL.to_dist(calib[path], CAL.NORM_SPEC)
        except ValueError:
            continue
        leaves.append(P.LeafSpec(path=path, size=size, last_dim=last_dim,
                                 dist=dist,
                                 scale_rms=CAL.scale_rms(calib[path])))
    if not leaves:
        return None
    fixed = format_name(ccfg.fmt)
    cands = P.candidate_formats(n_bits=atcfg.n_bits, h_bits=atcfg.h_bits,
                                signed=True)
    if fixed not in cands:
        cands.append(fixed)
    budget = atcfg.budget_bits_per_elem
    if budget is None:  # equal budget with the fixed single-format config
        tot = sum(sp.size for sp in leaves)
        budget = sum(P._leaf_bits(sp, fixed, ccfg.block)
                     for sp in leaves) / tot
    return P.solve(leaves, cands, budget, block=ccfg.block)


def _trace_round(hist: dict, r: int, **args) -> None:
    s_obs = obs.get()
    if s_obs is not None and s_obs.tracer is not None:
        tr = s_obs.tracer
        dur_us = hist["round_seconds"][-1] * 1e6
        tr.complete("fl.round", tr.now_us() - dur_us, dur_us, round=r,
                    **args)


def run_fed_avg(fcfg: FedAvgConfig, task=None, *, device="cuda",
                verbose: bool = False):
    """Run the simulator; returns a history dict:

    ``eval_loss`` per round (held-out deterministic batch), ``client_loss``
    (mean of final local losses), ``wire_bytes_per_round`` (sum over
    clients), ``round_seconds`` (wall), ``params``; with autotune on, also
    ``policy`` (the last solved FormatPolicy) and ``resolve_rounds``."""
    from repro_torch.autotune import calibrate as CAL
    from repro_torch.autotune.policy import leaf_path_str

    cfg, dcfg, loss_fn, init_params_fn = task or toy_task()
    params = init_params_fn(cfg, fcfg.seed, device)
    residuals = [C.init_client_residuals(params, fcfg.client)
                 for _ in range(fcfg.n_clients)]
    ccfg = fcfg.client
    client_fn = C.make_client_update(loss_fn, ccfg)
    eval_batch = _eval_batch(dcfg, device)

    autotuning = fcfg.autotune is not None and ccfg.compress
    calib: dict = {}

    reg = _registry("fl.fedavg", fcfg.seed)
    c_rounds = reg.counter("rounds")
    c_wire = reg.counter("wire_bytes")
    g_loss = reg.gauge("eval_loss_last")
    g_wire = reg.gauge("wire_bytes_last_round")

    hist = {"eval_loss": [], "client_loss": [], "wire_bytes_per_round": [],
            "round_seconds": [], "policy": None, "resolve_rounds": []}
    for r in range(fcfg.rounds):
        t0 = time.perf_counter()
        updates, round_losses = [], []
        with obs.span("fl.compute", round=r):
            for c in range(fcfg.n_clients):
                with obs.span("fl.client", round=r, client=c):
                    upd, residuals[c], losses = client_fn(
                        params, residuals[c],
                        _client_stream(dcfg, ccfg.local_steps, r, c, device))
                updates.append(upd)
                round_losses.append(losses[-1])
            delta = S.aggregate(updates)
        if autotuning:
            calib = CAL.update_tree(calib, delta, CAL.NORM_SPEC,
                                    block=ccfg.block,
                                    min_size=ccfg.min_size)
            if (r + 1) % fcfg.autotune.every == 0:
                meta = {leaf_path_str(p): (d.numel(), int(d.shape[-1]))
                        for p, d in _tree.leaves_with_path(delta)
                        if C._compressible(d, ccfg)}
                policy = _solve_policy(calib, meta, fcfg)
                if policy is not None and policy != ccfg.policy:
                    ccfg = dataclasses.replace(fcfg.client, policy=policy)
                    client_fn = C.make_client_update(loss_fn, ccfg)
                    hist["policy"] = policy
                    hist["resolve_rounds"].append(r)
                    if verbose:
                        print(f"round {r}: re-solved format policy\n"
                              f"{policy.describe()}", flush=True)
        with torch.no_grad():
            params = S.apply_update(params, delta, server_lr=fcfg.server_lr)
            ev = float(loss_fn(params, eval_batch))
        hist["round_seconds"].append(time.perf_counter() - t0)
        hist["eval_loss"].append(ev)
        hist["client_loss"].append(
            float(np.mean(torch.stack(round_losses).tolist())))
        hist["wire_bytes_per_round"].append(
            sum(S.wire_bytes(u) for u in updates))
        c_rounds.inc()
        c_wire.inc(hist["wire_bytes_per_round"][-1])
        g_loss.set(ev)
        g_wire.set(hist["wire_bytes_per_round"][-1])
        _trace_round(hist, r, eval_loss=ev)
        if verbose:
            print(f"round {r}: eval_loss {ev:.4f} "
                  f"client_loss {hist['client_loss'][-1]:.4f} "
                  f"wire {hist['wire_bytes_per_round'][-1]/1e6:.2f} MB "
                  f"({hist['round_seconds'][-1]:.2f}s)", flush=True)
    hist["params"] = params
    return hist


# ===========================================================================
# Fleet-scale straggler-tolerant rounds (DESIGN.md §10)
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Straggler-tolerant fed-avg over a large unreliable fleet.

    Each round samples ``sample`` of ``n_clients`` (over-provisioned: only
    ``quorum`` need arrive), computes client updates in chunks of
    ``client_batch``, and runs a SIMULATED clock: per-client arrival time =
    compute + straggler delay + retry backoff, arrivals after ``deadline``
    are buffered and folded into the NEXT round with staleness-discounted
    integer weights ``max(1, round(gamma^age * 2^weight_unit_bits))``,
    expiring after ``max_staleness`` rounds. Aggregation is the exact
    integer path (``fl.exact``), so the committed model is bit-identical
    under any arrival order or partial-aggregation schedule. A round
    commits only with >= ``quorum`` folded updates; otherwise arrivals
    carry over and the model stands still."""

    n_clients: int = 1000
    sample: int = 64
    quorum: int = 32
    rounds: int = 3
    client: C.ClientConfig = C.ClientConfig(scale_mode="pow2",
                                            error_feedback=False)
    server_lr: float = 1.0
    seed: int = 0
    # --- simulated time (seconds on the fleet's virtual clock) -------------
    compute_time: float = 1.0
    deadline: float = 8.0
    max_retries: int = 2
    backoff: float = 0.5          # retry k waits backoff * 2^(k-1)
    # --- staleness ----------------------------------------------------------
    staleness_gamma: float = 0.5
    max_staleness: int = 2
    weight_unit_bits: int = 8
    # --- compute scaling ----------------------------------------------------
    client_batch: int = 16        # clients per device-to-host transfer
    shard_clients: bool = True    # spread a chunk's lanes over the cards


def _local_devices() -> list:
    """The cards a fleet chunk may spread over: every local CUDA device."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _tree_to(tree, device):
    """``tree`` (QTensor leaves expanded) with every tensor on ``device``."""
    if tree is None:
        return None
    return _tree.unflatten(tree, [x.to(device) for x in _tree.leaves(
        tree, expand_q=True)], expand_q=True)


def _maybe_shard(lanes: list, flcfg: FleetConfig) -> list:
    """A chunk's per-lane trees spread over the local cards in equal runs
    of consecutive lanes, as the reference shards the chunk axis.
    Unchanged with ``shard_clients`` off, one card or none, or a
    ``client_batch`` the card count does not divide."""
    devices = _local_devices()
    n = len(devices)
    if not flcfg.shard_clients or n <= 1 or flcfg.client_batch % n:
        return lanes
    per = flcfg.client_batch // n
    return [_tree_to(t, devices[j // per]) for j, t in enumerate(lanes)]


def _to_host(trees: list) -> list:
    """Host copies of update trees (CPU tensors, same dtypes and bytes),
    every buffer of every tree in one device-to-host transfer: one buffer
    of bytes (uint8 views of every dtype), one copy."""
    flat = [_tree.leaves(t, expand_q=True) for t in trees]
    dev0 = flat[0][0].device   # lanes spread over cards meet on the first
    buf = torch.cat([x.detach().contiguous().reshape(-1).view(torch.uint8)
                     .to(dev0) for f in flat for x in f]).cpu()
    out, off = [], 0
    for t, f in zip(trees, flat):
        host = []
        for x in f:
            n = x.numel() * x.element_size()
            # a copy of its own: a view's offset need not suit the dtype
            host.append(buf[off:off + n].clone().view(x.dtype)
                        .reshape(x.shape))
            off += n
        out.append(_tree.unflatten(t, host, expand_q=True))
    return out


def _to_device(np_tree, device):
    """A host tree of f32 arrays (``ExactAggregator.finalize``) -> tensors
    on ``device`` in one host-to-device transfer."""
    arrs = [np.ascontiguousarray(a, np.float32) for a in _tree.leaves(np_tree)]
    flat = torch.from_numpy(np.concatenate([a.reshape(-1) for a in arrs]))
    flat = flat.to(device)
    out, off = [], 0
    for a in arrs:
        out.append(flat[off:off + a.size].reshape(a.shape))
        off += a.size
    return _tree.unflatten(np_tree, out)


def run_fleet_rounds(flcfg: FleetConfig, task=None, *, faults=None,
                     device="cuda", verbose: bool = False):
    """Run fleet rounds under an optional
    :class:`repro_torch.faults.FaultPlan`.

    Returns a history dict: per-round ``eval_loss``, ``committed``,
    ``admitted`` / ``late_folded`` / ``dropped`` / ``failed`` (retries
    exhausted) / ``quarantined`` / ``dup_skipped`` / ``expired`` /
    ``retries``, ``wire_bytes_per_round`` (every delivered payload, counted
    by the canonical packed accounting), ``sim_time`` (virtual clock) and
    ``round_seconds`` (wall), plus final ``params``."""
    from repro_torch.faults import FaultPlan, corrupt_update
    from repro_torch.fl.exact import (ExactAggregator, UpdateRejected,
                                      validate_update)

    plan = faults if faults is not None else FaultPlan()
    cfg, dcfg, loss_fn, init_params_fn = task or toy_task()
    params = init_params_fn(cfg, flcfg.seed, device)
    ccfg = flcfg.client
    chunk = max(1, flcfg.client_batch)
    client_fn = C.make_client_update(loss_fn, ccfg)
    eval_batch = _eval_batch(dcfg, device)
    zero_res = C.init_client_residuals(params, ccfg)
    res_store: dict[int, Any] = {}   # only populated with error_feedback
    unit = 1 << flcfg.weight_unit_bits
    late_buf: list[tuple[int, int, Any]] = []   # (emit_round, cid, update)

    hist: dict[str, Any] = {k: [] for k in (
        "eval_loss", "committed", "admitted", "late_folded", "dropped",
        "failed", "quarantined", "dup_skipped", "expired", "retries",
        "wire_bytes_per_round", "sim_time", "round_seconds")}

    reg = _registry("fl.fleet", flcfg.seed)
    c_st = {k: reg.counter(k) for k in (
        "dropped", "failed", "retries", "admitted", "late_folded",
        "quarantined", "dup_skipped", "expired")}
    c_rounds = reg.counter("rounds")
    c_committed = reg.counter("committed_rounds")
    c_wire = reg.counter("wire_bytes")
    g_loss = reg.gauge("eval_loss_last")
    g_sim = reg.gauge("sim_time_last")
    g_wire = reg.gauge("wire_bytes_last_round")
    # straggler arrival lag: how far past the nominal compute time each
    # delivered update lands (delay + retry backoff, virtual seconds)
    h_lag = reg.histogram("arrival_lag_s", 1e-3, 1e3)

    for r in range(flcfg.rounds):
        t0 = time.perf_counter()
        srng = np.random.default_rng(
            np.random.SeedSequence([flcfg.seed, 101, r]))
        n_s = min(flcfg.sample, flcfg.n_clients)
        cids = sorted(srng.choice(flcfg.n_clients, size=n_s,
                                  replace=False).tolist())

        # ---- client compute, chunk by chunk -------------------------------
        updates: dict[int, Any] = {}
        padded = cids + [cids[-1]] * (-len(cids) % chunk)
        replicas = {}   # the round's parameters on each lane device
        with obs.span("fl.compute", round=r):
            for i0 in range(0, len(padded), chunk):
                done, ups = [], []
                lanes = padded[i0:i0 + chunk]
                streams = _maybe_shard(
                    [_client_stream(dcfg, ccfg.local_steps, r, cid, device)
                     for cid in lanes], flcfg)
                for cid, batch in zip(lanes, streams):
                    if cid in updates or cid in done:
                        continue  # pad lane (duplicate of the chunk tail)
                    dev = batch["tokens"].device
                    if dev not in replicas:
                        replicas[dev] = _tree_to(params, dev)
                    with obs.span("fl.client", round=r, client=cid):
                        upd, new_res, _ = client_fn(
                            replicas[dev],
                            _tree_to(res_store.get(cid, zero_res), dev),
                            batch)
                    done.append(cid)
                    ups.append(upd)
                    if ccfg.error_feedback and ccfg.compress:
                        res_store[cid] = new_res
                # host copies for the wire
                updates.update(zip(done, _to_host(ups)))

        # ---- simulated delivery under the fault plan -----------------------
        st = {k: 0 for k in ("dropped", "failed", "retries", "admitted",
                             "late_folded", "quarantined", "dup_skipped",
                             "expired")}
        deliveries = []   # (arrival_time, emit_round, cid, update)
        for cid in cids:
            f = plan.client_fault(r, cid)
            if f.dropped:
                st["dropped"] += 1
                continue
            if f.transient_failures > flcfg.max_retries:
                st["failed"] += 1
                continue
            st["retries"] += f.transient_failures
            t_arr = flcfg.compute_time + f.delay + sum(
                flcfg.backoff * 2.0 ** k
                for k in range(f.transient_failures))
            h_lag.observe(t_arr - flcfg.compute_time)
            u = updates[cid]
            if f.corrupt is not None:
                u = corrupt_update(u, f.corrupt, plan.rng("corrupt", r, cid))
            for d in range(1 + f.duplicates):
                deliveries.append((t_arr + 1e-3 * d, r, cid, u))
        for er, cid, u in late_buf:
            if r - er > flcfg.max_staleness:
                st["expired"] += 1
                continue
            deliveries.append((0.0, er, cid, u))   # buffered: ready at start
        late_buf = []

        deliveries.sort(key=lambda a: (a[0], a[1], a[2]))
        admit = [a for a in deliveries if a[0] <= flcfg.deadline]
        late = [a for a in deliveries if a[0] > flcfg.deadline]

        # ---- fold (order-invariant: reorder cannot change the bits) --------
        agg = ExactAggregator()
        seen: set[tuple[int, int]] = set()
        wire = 0
        for k in plan.arrival_order(r, len(admit)):
            t_arr, er, cid, u = admit[k]
            wire += S.wire_bytes(u)
            if (er, cid) in seen:
                st["dup_skipped"] += 1
                continue
            seen.add((er, cid))
            age = r - er
            try:
                validate_update(u)
                agg.add(u, max(1, round(flcfg.staleness_gamma ** age * unit))
                        if age else unit)
            except UpdateRejected as e:
                st["quarantined"] += 1
                if verbose:
                    print(f"round {r}: quarantined client {cid}: {e}",
                          flush=True)
                continue
            st["admitted"] += 1
            if age:
                st["late_folded"] += 1

        committed = agg.n_folded >= flcfg.quorum
        with torch.no_grad():
            if committed:
                params = S.apply_update(params,
                                        _to_device(agg.finalize(), device),
                                        server_lr=flcfg.server_lr)
            else:
                # graceful degradation: the model stands still; everything
                # that DID arrive re-folds next round at age+1
                for k in sorted(seen):
                    er, cid = k
                    u = next(u for _, e2, c2, u in admit
                             if (e2, c2) == (er, cid))
                    late_buf.append((er, cid, u))
            late_buf.extend((er, cid, u) for _, er, cid, u in late)
            ev = float(loss_fn(params, eval_batch))
        sim = max([a[0] for a in admit], default=0.0)
        hist["eval_loss"].append(ev)
        hist["committed"].append(committed)
        for key in st:
            hist[key].append(st[key])
        hist["wire_bytes_per_round"].append(int(wire))
        hist["sim_time"].append(float(sim))
        hist["round_seconds"].append(time.perf_counter() - t0)
        for key, n in st.items():
            if n:
                c_st[key].inc(n)
        c_rounds.inc()
        if committed:
            c_committed.inc()
        c_wire.inc(wire)
        g_loss.set(ev)
        g_sim.set(float(sim))
        g_wire.set(wire)
        _trace_round(hist, r, committed=committed, admitted=st["admitted"],
                     eval_loss=ev)
        if verbose:
            print(f"round {r}: eval_loss {ev:.4f} committed={committed} "
                  f"admitted {st['admitted']} (late {st['late_folded']}) "
                  f"dropped {st['dropped']} failed {st['failed']} "
                  f"quarantined {st['quarantined']} "
                  f"wire {wire / 1e6:.2f} MB sim {sim:.2f}s "
                  f"({hist['round_seconds'][-1]:.2f}s wall)", flush=True)
    hist["params"] = params
    return hist
