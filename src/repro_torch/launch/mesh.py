"""Device meshes over a ``torch.distributed`` world (port of
``repro.launch.mesh``), and the collectives the sharded paths use.

Functions, not module-level constants: importing this module touches no
process group. A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh`
over the world's ranks, laid out row-major over ``shape`` as the
reference's ``jax.make_mesh``; its device type is the ranks' device (the
card, or the CPU where the caller asks for it).

Production shapes (the reference's TPU pods; on cards the world must have
the same size):

    single pod: (16, 16)    = ("data", "model")
    two pods:   (2, 16, 16) = ("pod", "data", "model")

Collectives: :func:`all_reduce`, :func:`reduce_scatter` and
:func:`all_gather` run on a process group. A gloo group moves CPU tensors
(the port's CPU ranks, and ranks that share one card, which NCCL refuses),
so on gloo a CUDA tensor's leg is staged through host memory by design:
the tensor is copied to the host, reduced or gathered there and copied
back. Each staged leg is named once in :data:`HOST_STAGED`, and every leg
counts its calls and the bytes this rank hands to it in :data:`LEGS`
(the model-axis collectives of ``models.parallel`` run on these legs).
"""
from __future__ import annotations

import contextlib
import math
import warnings

import torch
import torch.distributed as dist

# names of the legs staged through host memory (gloo + CUDA tensors)
HOST_STAGED: set[str] = set()
# leg name -> [calls, bytes handed to the collective by this rank]
LEGS: dict[str, list[int]] = {}


def reset_legs() -> None:
    LEGS.clear()


def _count(t: torch.Tensor, leg: str) -> None:
    rec = LEGS.setdefault(leg, [0, 0])
    rec[0] += 1
    rec[1] += t.numel() * t.element_size()


def rank_device(device=None) -> torch.device:
    """The device of this rank: ``device`` when given, else the card of
    index ``rank % cards`` (ranks share cards round-robin when there are
    more ranks than cards). With no card and no ``device`` it raises: a
    rank runs on the CPU only when the caller asks for it."""
    if device is not None:
        return torch.device(device)
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device for this rank: pass "
                           "device='cpu' to run it on the CPU")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % n)


@contextlib.contextmanager
def fake_world(n: int):
    """Join rank 0 of a fake process group of ``n`` ranks (collectives
    return at once, moving nothing) for the duration of the block, then
    destroy it: the counterpart of the reference's
    ``--xla_force_host_platform_device_count`` placeholder devices, for
    the dry run on the CPU (``device="cpu"`` meshes)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is initialized already")
    dist.init_process_group("fake", rank=0, world_size=int(n),
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def compat_make_mesh(shape, axes, device=None):
    """A DeviceMesh of ``shape`` named ``axes`` over every rank of the
    world (row-major, as ``jax.make_mesh``), of the ranks' device type."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; the "
                         f"world has {world}")
    return init_device_mesh(rank_device(device).type, shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    return compat_make_mesh(shape, axes, device)


def data_axes(mesh) -> tuple[str, ...]:
    """Mesh axes carrying the batch (pod folds into data-parallel)."""
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def make_host_mesh(n: int | None = None, name: str = "data", device=None):
    """A 1-D mesh named ``name`` over every rank of the world; ``n``, when
    given, must be the world's size (the reference takes the first ``n``
    devices; a DeviceMesh here spans the whole world)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return compat_make_mesh((world if n is None else n,), (name,), device)


def make_sketch_mesh(n: int | None = None, device=None):
    """1-D mesh for row-sharding a sketch's ``(depth, width)`` register
    state (``repro_torch.sketch``); its axis is ``"rows"``, and ``n`` must
    divide the sketch depth."""
    return make_host_mesh(n, name="rows", device=device)


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size of a DeviceMesh (or of a plain dict, which
    passes: the spec helpers take either)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


# ---------------------------------------------------------------------------
# Collectives (host-staged on gloo for CUDA tensors)
# ---------------------------------------------------------------------------
def _staged(t: torch.Tensor, group, leg: str) -> bool:
    _count(t, leg)
    if t.device.type != "cuda" or dist.get_backend(group) != "gloo":
        return False
    HOST_STAGED.add(leg)
    return True


def all_reduce(t: torch.Tensor, group=None, leg: str = "all_reduce",
               op=dist.ReduceOp.SUM):
    """Reduce ``t`` over ``group`` in place (a sum, or ``op``); returns
    ``t``."""
    if _staged(t, group, leg):
        h = t.cpu()
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
        return t
    dist.all_reduce(t, op=op, group=group)
    return t


def reduce_scatter(t: torch.Tensor, group=None, leg: str = "reduce_scatter"):
    """Sum ``t`` over ``group`` and return this rank's equal slice of rows
    (``t.shape[0]`` must divide by the group's size)."""
    w = dist.get_world_size(group)
    staged = _staged(t, group, leg)
    src = t.cpu() if staged else t.contiguous()
    out = torch.empty((src.shape[0] // w, *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(t.device) if staged else out


def all_gather(t: torch.Tensor, group=None, leg: str = "all_gather"):
    """Concatenate every rank's ``t`` along dim 0, in rank order. Integer
    tensors (codes, packed words) travel as their bytes: gloo has no
    unsigned 16- or 32-bit type."""
    w = dist.get_world_size(group)
    staged = _staged(t, group, leg)
    src = t.cpu().contiguous() if staged else t.contiguous()
    raw = src if src.is_floating_point() else src.view(torch.uint8)
    out = torch.empty((w * raw.shape[0], *raw.shape[1:]), dtype=raw.dtype,
                      device=raw.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, raw, group=group)
    out = out if raw is src else out.view(src.dtype)
    return out.to(t.device) if staged else out

