"""Op-level cost count of one step (the port's counterpart of
``repro.launch.hlo_analysis``).

The reference parses XLA's optimized HLO text. The port runs eagerly, so
the step itself is the program: :class:`OpAnalysis` is a
``TorchDispatchMode`` that sees every aten op the step runs (forward,
backward and optimizer; on real tensors or on fake ones), and every
hand-written kernel through :func:`repro_torch.kernels.cost.charged`.
Eager loops run their real trip count, so no multiplier is needed.

  * FLOPs: every matmul-like aten op, by ``torch.utils.flop_counter``'s
    per-op formulas (the ``dot`` FLOPs the reference counts); a kernel
    adds its ``flops`` (``kernels.cost``), and the ops inside it count
    nothing.
  * HBM bytes: each aten op's operands plus its result (an eager op
    reads its inputs from memory and writes its output back), except:
    views and metadata ops are free; gathers (``index``,
    ``index_select``, ``gather``, ``embedding``) are charged twice their
    result, not the table they read from; in-place slice updates
    (``index_put_``, ``scatter_``, ``copy_`` into a view) twice the
    update; a kernel its ``nbytes`` once, nothing inside it. A kernel
    plays the part of the reference's fusion.
  * Collectives: every ``c10d`` and ``_c10d_functional`` op, with its
    group's size and the ring model (``launch.roofline.moved_bytes``),
    counted per call.
  * Memory: ``argument_size_in_bytes`` (the step's inputs, each storage
    once; a DTensor's local shard), ``output_size_in_bytes`` (its
    outputs, each storage once, in-place results included as XLA counts
    donated outputs) and ``temp_size_in_bytes``: the peak bytes of the
    storages the step allocated that were alive at once, tracked by weak
    references on the storages (of a kernel, its results: what a plain
    version allocates inside it is not the kernel's). XLA's ``alias_size_in_bytes``,
    ``generated_code_size_in_bytes`` and ``xla_flops_body_once`` have no
    counterpart and are left out.

Under fake tensors (the dry run) a kernel's wrapper is not run: the
analysis returns its ``fake`` results, so no plain version's
data-dependent op is reached.
"""
from __future__ import annotations

import threading
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost
from repro_torch.launch.roofline import moved_bytes

aten = torch.ops.aten

# no traffic: allocation without a write, metadata, host reads
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten._unsafe_view.default,
         aten.detach.default, aten.lift_fresh.default,
         aten._local_scalar_dense.default, aten.sym_size.int,
         aten.sym_stride.int, aten.sym_numel.default,
         aten.is_same_size.default, aten.set_.source_Storage_storage_offset,
         aten.resize_.default}
# gathers: read what they return, write it once
_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.gather.default, aten.embedding.default, aten.take.default}
# in-place updates of part of their destination -> the update's argument
_UPDATES = {aten.index_put_.default: 2, aten._index_put_impl_.default: 2,
            aten.scatter_.src: 3, aten.scatter_reduce_.two: 3,
            aten.index_add_.default: 3, aten.index_copy_.default: 3}

# collective op name -> ring-model kind
_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "collective-permute", "broadcast": "collective-permute",
}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nb(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _is_view(func) -> bool:
    """A non-mutating alias of an input (a view, ``split``, ``t``)."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _composite(func) -> bool:
    """An aten op that only decomposes (CompositeImplicitAutograd, no
    kernel of its own on a device) and has no FLOP formula."""
    if func.namespace != "aten" or func._overloadpacket in flop_registry:
        return False
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    name = func.name()
    return has(name, "CompositeImplicitAutograd") and not any(
        has(name, k) for k in ("CPU", "CUDA", "CompositeExplicitAutograd"))


def _group_size(func, args, kwargs) -> int:
    """The size of a collective's process group: its ``process_group``
    argument (``c10d``) or the group its ``group_name`` names
    (``_c10d_functional``)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for i, arg in enumerate(func._schema.arguments):
        if arg.name not in ("process_group", "group_name"):
            continue
        pg = args[i] if i < len(args) else kwargs.get(arg.name)
        if isinstance(pg, str):
            pg = _resolve_process_group(pg)
        elif isinstance(pg, torch.ScriptObject):
            pg = dist.ProcessGroup.unbox(pg)
        return pg.size()
    return dist.get_world_size() if dist.is_initialized() else 1


def walk_tensors(obj, seen=None):
    """Every tensor reachable from ``obj`` (tensors, Modules' parameters
    and buffers, dicts, lists, tuples, QTensors), each DTensor as its local
    shard."""
    from torch import nn

    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield _local(obj)
    elif isinstance(obj, nn.Module):
        for t in obj.parameters():
            yield _local(t.data)
        for t in obj.buffers():
            yield _local(t)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from walk_tensors(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from walk_tensors(v, seen)
    elif hasattr(obj, "codes") and hasattr(obj, "scales"):   # a QTensor
        yield from walk_tensors((obj.codes, obj.scales), seen)


def storage_bytes(obj) -> int:
    """Bytes of the storages behind the tensors of ``obj``, each once."""
    seen, total = set(), 0
    for t in walk_tensors(obj):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


class OpAnalysis(TorchDispatchMode):
    """Count one step's FLOPs, HBM bytes and collectives while it runs (see
    the module docstring); ``result()`` returns the counts."""

    def __init__(self, fake: bool = False):
        super().__init__()
        self.fake = fake
        self.flops = 0
        self.hbm_bytes = 0
        self.ring_bytes = 0.0
        self.naive_bytes = 0.0
        self.per_op = defaultdict(lambda: {"count": 0.0, "bytes": 0.0,
                                           "moved": 0.0})
        self.kernels = defaultdict(lambda: {"count": 0, "bytes": 0,
                                            "flops": 0})
        self.by_op = defaultdict(lambda: {"count": 0, "bytes": 0,
                                          "flops": 0})
        self._inside = 0
        self._depth = 0
        self._known: set = set()    # storages not the step's own
        self._live = 0
        self.peak = 0
        self.thread = None          # the thread it counts, from __enter__

    # -- the mode ---------------------------------------------------------
    def __enter__(self):
        if not self._depth:
            if cost.ACTIVE is not None:
                raise RuntimeError("an op analysis is running already")
            self.thread = threading.get_ident()
            cost.ACTIVE = self
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if not self._depth:
            cost.ACTIVE = None
        return super().__exit__(*exc)

    def know(self, obj) -> None:
        """Mark the storages of ``obj`` (the step's inputs) as not the
        step's own: they do not count as its temporaries."""
        for t in walk_tensors(obj):
            self._known.add(t.untyped_storage()._cdata)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func):
            # outside autograd (inference mode) composite ops such as
            # matmul arrive whole: count what they decompose into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not self._inside:
            self._track(out)
            self._charge(func, args, kwargs, out)
        return out

    def kernel(self, name: str, fn, args, kwargs):
        """A charged kernel wrapper's call: its cost once, nothing inside
        it; under fake tensors its fake results instead of running it."""
        outer = not self._inside
        self._inside += 1
        try:
            c = cost.COSTS[name]
            a = cost.bind(name, args, kwargs)
            if outer:
                nb, fl = int(c.nbytes(a)), int(c.flops(a))
                self.hbm_bytes += nb
                self.flops += fl
                k = self.kernels[name]
                k["count"] += 1
                k["bytes"] += nb
                k["flops"] += fl
            out = c.fake(a) if self.fake else fn(*args, **kwargs)
        finally:
            self._inside -= 1
        if outer:   # its results, not the plain version's temporaries
            self._track(out)
        return out

    # -- charging ---------------------------------------------------------
    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known:
                continue
            self._known.add(key)
            n = st.nbytes()
            self._live += n
            self.peak = max(self.peak, self._live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._live -= n
        self._known.discard(key)

    def _charge(self, func, args, kwargs, out) -> None:
        if func.namespace in ("c10d", "_c10d_functional"):
            self._collective(func, args, kwargs, out)
            return
        if func.namespace != "aten":    # prim.device and the like
            return
        packet = func._overloadpacket
        fl = 0
        if packet in flop_registry:
            fl = int(flop_registry[packet](*args, **kwargs, out_val=out))
        nb = self._op_bytes(func, args, kwargs, out)
        self.flops += fl
        self.hbm_bytes += nb
        if fl or nb:
            slot = self.by_op[packet.__name__]
            slot["count"] += 1
            slot["bytes"] += nb
            slot["flops"] += fl

    @staticmethod
    def _op_bytes(func, args, kwargs, out) -> int:
        if func in _FREE or _is_view(func):
            return 0
        if func in _GATHERS:
            return 2 * sum(_nb(t) for t in _tensors(out))
        if func in _UPDATES:
            return 2 * _nb(args[_UPDATES[func]])
        if func is aten.copy_.default:
            return _nb(args[0]) + _nb(args[1])
        ins = sum(_nb(_local(t)) for t in _tensors((args, kwargs)))
        return ins + sum(_nb(_local(t)) for t in _tensors(out))

    def _collective(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        kind = _COLLECTIVES.get(name)
        if kind is None:    # barrier, wait_tensor, monitored_barrier ...
            return
        # a c10d op's first argument holds its result (the output buffers,
        # or the tensors reduced in place); a functional op returns it
        res = _tensors(args[:1] if func.namespace == "c10d" else out)
        b = sum(_nb(_local(t)) for t in res)
        n = _group_size(func, args, kwargs)
        moved = moved_bytes(kind, b, n)
        self.ring_bytes += moved
        self.naive_bytes += b
        self.hbm_bytes += b + sum(_nb(_local(t)) for t in _tensors(args))
        slot = self.per_op[kind]
        slot["count"] += 1
        slot["bytes"] += b
        slot["moved"] += moved

    def result(self, args=None, out=None) -> dict:
        r = {"flops": float(self.flops), "hbm_bytes": float(self.hbm_bytes),
             "ring_bytes": self.ring_bytes, "naive_bytes": self.naive_bytes,
             "per_op": {k: dict(v) for k, v in self.per_op.items()},
             "kernels": {k: dict(v) for k, v in self.kernels.items()},
             "by_op": {k: dict(v) for k, v in self.by_op.items()},
             "temp_size_in_bytes": self.peak}
        if args is not None:
            r["argument_size_in_bytes"] = storage_bytes(args)
        if out is not None:
            r["output_size_in_bytes"] = storage_bytes(out)
        return r


def analyze(fn, *args, fake: bool = False, **kwargs):
    """Run ``fn(*args, **kwargs)`` under :class:`OpAnalysis` (``fake``:
    the arguments are fake tensors); returns (fn's result, the counts)."""
    with OpAnalysis(fake=fake) as a:
        a.know((args, kwargs))
        out = fn(*args, **kwargs)
    return out, a.result(args=(args, kwargs), out=out)
