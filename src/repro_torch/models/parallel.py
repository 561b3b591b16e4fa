"""Model-axis parallel layers: the collectives that join a split layer's
parts, as autograd sees them.

The sharded train step runs the model inside :func:`model_axis`; a layer
that holds this rank's part of its weights then computes its part and
joins the parts with:

- :func:`to_model` where a replicated tensor enters a split layer:
  identity forward, its gradient (each rank's part) summed over the model
  group backward;
- :func:`from_model` where a split layer's partial output leaves it: a sum
  over the model group forward, identity backward;
- over a tensor dim, :func:`gather_model` (all-gather forward,
  reduce-scatter backward) where each rank goes on with its own part of
  the gathered tensor, :func:`gather_model_replicated` (all-gather
  forward, this rank's chunk of the gradient backward) where every rank
  goes on alike, and :func:`chunk_model` (this rank's chunk forward,
  all-gather backward).

Partial sums add in f32 (one all-reduce) and are cast once. Each
collective is a named leg of ``launch.mesh`` (host-staged on gloo for CUDA
tensors, counted in ``launch.mesh.LEGS``); the context takes them from
there, so a model outside a model axis never reaches the launcher.
"""
from __future__ import annotations

import contextlib

import torch

_MODEL = {}


@contextlib.contextmanager
def model_axis(mesh):
    """Run the block with ``mesh``'s "model" dim as the group of the
    model-axis collectives below (a split layer finds it here)."""
    from repro_torch.launch import mesh as legs

    prev = dict(_MODEL)
    _MODEL.update(group=mesh.get_group("model"), size=mesh.size(
        mesh.mesh_dim_names.index("model")),
        rank=mesh.get_local_rank("model"), legs=legs)
    try:
        yield
    finally:
        _MODEL.clear()
        _MODEL.update(prev)


def model_rank() -> int:
    """This rank's index on the model axis; a split layer outside
    :func:`model_axis` raises."""
    if not _MODEL:
        raise RuntimeError("a layer holds part of its weights, but no "
                           "model axis is set (models.parallel.model_axis)")
    return _MODEL["rank"]


def model_size() -> int:
    """The model axis's size inside :func:`model_axis`, else 1."""
    return _MODEL.get("size", 1)


def _axis() -> tuple:
    """(group, size, rank, legs) of the model axis, taken when a
    collective is built, so its backward (on autograd's thread) needs no
    context."""
    model_rank()
    return _MODEL["group"], _MODEL["size"], _MODEL["rank"], _MODEL["legs"]


def _sum_f32(t: torch.Tensor, ax: tuple, leg: str) -> torch.Tensor:
    """A new tensor: ``t`` summed over the model group in f32, cast back
    once (every rank gets the same bits)."""
    s = t.to(torch.float32)
    s = s.clone() if s is t else s
    ax[3].all_reduce(s, ax[0], leg)
    return s.to(t.dtype)


def _gather_dim(t: torch.Tensor, dim: int, ax: tuple, leg: str):
    moved = t.movedim(dim, 0).contiguous()
    return ax[3].all_gather(moved, ax[0], leg).movedim(0, dim)


def _scatter_dim(t: torch.Tensor, dim: int, ax: tuple, leg: str):
    """``t`` summed over the model group in f32, this rank's chunk of
    ``dim``, cast back once."""
    moved = t.movedim(dim, 0).to(torch.float32).contiguous()
    out = ax[3].reduce_scatter(moved, ax[0], leg)
    return out.movedim(0, dim).to(t.dtype)


def _chunk(t: torch.Tensor, dim: int, ax: tuple) -> torch.Tensor:
    return t.chunk(ax[1], dim=dim)[ax[2]].contiguous()


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, leg):
        ctx.ax, ctx.leg = ax, leg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.ax, ctx.leg + "_all_reduce_bwd"), None, None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, leg):
        return _sum_f32(x, ax, leg + "_all_reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax, leg, replicated):
        ctx.dim, ctx.ax, ctx.leg, ctx.replicated = dim, ax, leg, replicated
        return _gather_dim(x, dim, ax, leg + "_all_gather")

    @staticmethod
    def backward(ctx, g):
        if ctx.replicated:
            g = _chunk(g, ctx.dim, ctx.ax)
        else:
            g = _scatter_dim(g, ctx.dim, ctx.ax,
                             ctx.leg + "_reduce_scatter_bwd")
        return g, None, None, None, None


class _ChunkModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax, leg):
        ctx.dim, ctx.ax, ctx.leg = dim, ax, leg
        return _chunk(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return (_gather_dim(g, ctx.dim, ctx.ax, ctx.leg + "_all_gather_bwd"),
                None, None, None)


def to_model(x: torch.Tensor, leg: str) -> torch.Tensor:
    """A replicated tensor entering a split layer: identity; its gradient
    (each rank's part) is summed over the model group."""
    return _ToModel.apply(x, _axis(), leg)


def from_model(x: torch.Tensor, leg: str) -> torch.Tensor:
    """A split layer's partial output, summed over the model group (every
    rank then holds the whole); its gradient passes as it is."""
    return _FromModel.apply(x, _axis(), leg)


def gather_model(x: torch.Tensor, dim: int, leg: str) -> torch.Tensor:
    """Every rank's chunk concatenated along ``dim``, for work that differs
    by rank: the gradient is summed over the ranks and each keeps its
    chunk."""
    return _GatherModel.apply(x, dim, _axis(), leg, False)


def gather_model_replicated(x: torch.Tensor, dim: int,
                            leg: str) -> torch.Tensor:
    """Every rank's chunk concatenated along ``dim``, for work that every
    rank repeats alike: each rank keeps its chunk of the gradient."""
    return _GatherModel.apply(x, dim, _axis(), leg, True)


def chunk_model(x: torch.Tensor, dim: int, leg: str) -> torch.Tensor:
    """This rank's chunk of a replicated tensor along ``dim`` (no
    communication); the gradient is gathered back whole."""
    return _ChunkModel.apply(x, dim, _axis(), leg)


def max_over_model(x: torch.Tensor, leg: str) -> torch.Tensor:
    """The elementwise max over the model group (no gradient)."""
    import torch.distributed as dist

    ax = _axis()
    out = x.detach().clone()
    ax[3].all_reduce(out, ax[0], leg + "_all_reduce_max",
                     op=dist.ReduceOp.MAX)
    return out
