"""Logical-axis sharding (port of ``repro.models.sharding``).

Models annotate activations with *logical* axis names through
:func:`constrain`; launchers install a rules table mapping logical names
to mesh axes (or None). Outside a rules context, and on a plain tensor,
every constraint is a no-op; on a DTensor it redistributes to the
placements the rules give.

A spec is a tuple with one entry per tensor dim: None, a mesh axis name,
or a tuple of names (the reference's ``PartitionSpec``). On a DeviceMesh it
becomes DTensor placements one for one (:func:`placements`): a mesh axis
named in dim ``d``'s entry is ``Shard(d)`` on that mesh dim, every other
mesh dim is ``Replicate()``.

Parameter specs come from the parameter names by pattern rules
(:func:`param_specs`), so model init stays sharding-free. The reference
stacks each pattern position's layers ``[G, ...]`` under ``blocks`` /
``encoder`` and prepends a scan-group ``None``; the port keeps one tensor
per layer, so the rules run on the reference's (stacked) rank and that
leading ``None`` is dropped, which keeps every quirk of the reference's
table (a stacked 2-D FF weight is 3-D there and takes the MoE entry).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

import torch

_STATE = threading.local()


def current_rules():
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def logical_rules(rules: dict[str, Any], mesh=None):
    """rules: logical axis name -> mesh axis name | tuple | None. With
    ``mesh`` the constraints resolve on it; else on each DTensor's own."""
    prev = (current_rules(), getattr(_STATE, "mesh", None))
    _STATE.rules, _STATE.mesh = rules, mesh
    try:
        yield
    finally:
        _STATE.rules, _STATE.mesh = prev


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec) if axis in _names(e)]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} names mesh axis {axis!r} twice")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _spec(rules: dict, axes: tuple) -> tuple:
    return tuple(rules.get(a) if a is not None else None for a in axes)


def constrain(x, logical_axes):
    """Redistribute a DTensor ``x`` to the rules' placements of
    ``logical_axes``; a no-op outside a rules context or on a plain
    tensor."""
    rules = current_rules()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    axes = tuple(logical_axes)
    axes = axes[-x.ndim:] if len(axes) > x.ndim else \
        axes + (None,) * (x.ndim - len(axes))
    mesh = getattr(_STATE, "mesh", None) or x.device_mesh
    return x.redistribute(mesh, placements(_spec(rules, axes), mesh))


# ---------------------------------------------------------------------------
# Parameter shardings by name pattern
# ---------------------------------------------------------------------------
# leaf name -> logical axes (without the reference's leading scan dim)
_PARAM_AXES = {
    "embed": ("vocab", "fsdp"),
    "lm_head": ("fsdp", "vocab"),
    "vision_proj": (None, "fsdp"),
    # attention
    "wq": ("fsdp", "heads"),
    "wk": ("fsdp", "heads"),
    "wv": ("fsdp", "heads"),
    "wo": ("heads", "fsdp"),
    # dense ff
    "gate": ("fsdp", "ff"),
    "up": ("fsdp", "ff"),
    "down": ("ff", "fsdp"),
    # moe (3-D expert weights under "ff" are remapped below)
    "router": ("fsdp", None),
    # mamba
    "in_proj": ("fsdp", "inner"),
    "out_proj": ("inner", "fsdp"),
    "x_proj": ("inner", None),
    "dt_proj": (None, "inner"),
    "dt_bias": ("inner",),
    "conv_w": (None, "inner"),
    "conv_b": ("inner",),
    "a_log": ("inner", None),
    "d_skip": ("inner",),
    # xlstm
    "wqkv": ("fsdp", "inner"),
    "w_gates": ("fsdp", None),
    "b_gates": (None,),
    "w_ogate": ("fsdp", "inner"),
    "w_in": ("fsdp", "inner"),
    "r_blocks": ("heads_nodata", None, None),
    "bias": (None,),
}


def _leaf_axes(name: str, ndim: int) -> tuple:
    """Logical axes of the port's parameter ``name`` of rank ``ndim``: the
    reference's rule on its stacked leaf, leading scan dim dropped."""
    from repro_torch.models.convert import reference_path

    path, _ = reference_path(name, 1)
    names = list(path)
    leaf = names[-1]
    stacked = "blocks" in names
    ref_ndim = ndim + 1 if stacked else ndim
    in_moe = "ff" in names and ref_ndim >= 3
    in_shared = "shared" in names
    if in_moe and leaf in ("gate", "up", "down"):
        axes = {"gate": ("experts", "fsdp", "ff_nomodel"),
                "up": ("experts", "fsdp", "ff_nomodel"),
                "down": ("experts", "ff_nomodel", "fsdp")}[leaf]
    elif in_shared and leaf in ("gate", "up", "down"):
        axes = {"gate": ("fsdp", "ff"), "up": ("fsdp", "ff"),
                "down": ("ff", "fsdp")}[leaf]
    elif leaf.startswith("norm") or leaf == "final_norm":
        return (None,) * ndim
    else:
        axes = _PARAM_AXES.get(leaf, (None,) * ref_ndim)
    if stacked:
        axes = (None,) + tuple(axes)
    if len(axes) != ref_ndim:
        axes = tuple(axes[:ref_ndim]) + (None,) * (ref_ndim - len(axes))
    return tuple(axes[1:]) if stacked else tuple(axes)


def _named(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return params


def param_logical_axes(params) -> dict:
    """name -> logical axes for a ``Model`` or name -> tensor dict."""
    return {n: _leaf_axes(n, p.ndim) for n, p in _named(params).items()}


def param_specs(params, rules: dict[str, Any]) -> dict:
    """name -> spec of every parameter under ``rules``."""
    return {n: _spec(rules, a) for n, a in param_logical_axes(params).items()}


def param_shardings(params, mesh, rules: dict[str, Any]) -> dict:
    return {n: NamedSharding(mesh, s)
            for n, s in param_specs(params, rules).items()}


# ---------------------------------------------------------------------------
# Layer kinds of model-axis parallel training
# ---------------------------------------------------------------------------
# the kinds of layer a model rank can compute split, by the logical axis
# the rules give "model": vocab (embedding and head), heads (attention,
# cross-attention and the encoder's), ff (dense FF and the shared expert),
# experts (an MoE's routed experts), and the recurrent mixers' inner /
# heads_nodata channels
SPLIT_KINDS = ("vocab", "heads", "ff", "experts", "mamba", "mlstm", "slstm")


def leaf_kind(name: str, cfg) -> str | None:
    """The split kind of the layer that holds the port's parameter
    ``name`` (a :data:`SPLIT_KINDS` entry), or None for a leaf no split
    layer holds (norms, ``vision_proj``)."""
    parts = name.split(".")
    if parts[-1] in ("embed", "lm_head"):
        return "vocab"
    if parts[0] == "encoder" or "cross" in parts:
        return None if parts[-1].startswith("norm") else (
            "ff" if "ff" in parts else "heads")
    if parts[0] != "blocks" or parts[-1].startswith("norm"):
        return None
    spec = cfg.pattern[int(parts[1]) % len(cfg.pattern)]
    if "ff" in parts:
        return "ff" if "shared" in parts or spec.ff == "dense" else "experts"
    return "heads" if spec.mixer == "attn" else spec.mixer


# ---------------------------------------------------------------------------
# Standard rule tables
# ---------------------------------------------------------------------------
def make_rules(*, data_axes=("data",), model_axis="model", fsdp: bool,
               seq_on_data: bool = False) -> dict[str, Any]:
    """The framework's standard logical -> mesh mapping.

    data_axes: mesh axes for the batch (("pod", "data") on the multi-pod
    mesh). fsdp: shard the params' d_model / reduction dim over the data
    axes too (ZeRO-3 style). seq_on_data: context parallelism (batch 1).
    """
    da = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
    return {
        "batch": None if seq_on_data else da,
        "seq": da if seq_on_data else None,
        "seq_sp": model_axis,   # sequence parallelism (residual stream)
        "vocab": model_axis,
        "heads": model_axis,
        "ff": model_axis,
        "ff_nomodel": None,          # moe expert ff dim (experts take "model")
        "experts": model_axis,
        "inner": model_axis,         # mamba/xlstm channel dim
        "heads_nodata": model_axis,
        "fsdp": da if fsdp else None,
        "kv": model_axis,
    }
