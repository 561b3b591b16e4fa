"""Specs and shardings of whole trees (port of ``repro.launch.shardings``):
the train state, the parameters and the caches of a config on a mesh,
built on abstract (``meta``) tensors, nothing allocated.

Also the cache sharding rules (matched on leaf names, as
``models.sharding`` does for parameters), and the DTensor plumbing of the
sharded train state: :func:`shard_tensor` places a full tensor's local
slice on the mesh (the reference's ``device_put`` onto a sharding, with no
communication), :func:`gather_full` rebuilds the full tensor on every
rank, and :func:`shard_state` turns a train state into DTensors.

A mesh here is a DeviceMesh, or a plain ``{axis: size}`` dict where only
the sizes matter (:func:`sanitize_spec`, :func:`rules_for`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.launch import mesh as M
from repro_torch.launch.mesh import data_axes, mesh_shape
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (SPLIT_KINDS, NamedSharding, _names,
                                         leaf_kind, make_rules, param_specs)

# cache leaf name -> logical axes (leading group dim added automatically).
# A packed KV cache holds QTensors under "k"/"v": words [G, B, S, K, W] and
# scales [G, B, S, K, 1] have the same rank and leading axes, so one entry
# per cache key covers dense and quantized layouts alike.
_CACHE_AXES = {
    "k": ("batch", "kv_seq", "kv", None),
    "v": ("batch", "kv_seq", "kv", None),
    "conv": ("batch", None, "inner"),
    "ssm": ("batch", "inner", None),
    "C": ("batch", "heads_nodata", None, None),
    "n": ("batch", "heads_nodata", None),
    "m": ("batch", "heads_nodata"),
    "c": ("batch", "inner"),
    "h": ("batch", "inner"),
}


def rules_for(cfg: ModelConfig, mesh, shape_name: str) -> dict:
    """Logical -> mesh table for one cell. long_500k (batch 1) spreads the
    KV cache's sequence over the data axes too (context parallelism)."""
    is_long = shape_name.startswith("long")
    da = data_axes(mesh)
    r = make_rules(data_axes=da, model_axis="model", fsdp=cfg.fsdp,
                   seq_on_data=False)
    # the KV cache's sequence axis shards over "model": it divides for every
    # arch, unlike the kv-head counts
    r["kv_seq"] = tuple([*da, "model"]) if is_long else "model"
    if is_long:
        r["batch"] = None
    r["kv"] = None
    return r


def _axis_size(mesh, assignment) -> int:
    sizes = mesh_shape(mesh)
    return math.prod(sizes[a] for a in _names(assignment))


def sanitize_spec(shape: tuple, spec: tuple, mesh) -> tuple:
    """Replicate every spec entry whose mesh-axis product does not divide
    its dim: DTensor shards here are always even."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(e if e is None or dim % _axis_size(mesh, e) == 0 else None
                 for dim, e in zip(shape, entries))


def named_sharding(mesh, shape: tuple, spec: tuple) -> NamedSharding:
    return NamedSharding(mesh, sanitize_spec(tuple(shape), spec, mesh))


def cache_specs(cache_tree: dict, rules: dict) -> dict:
    """Specs of a ``models.init_caches`` tree ``{"b<i>": {name: leaf}}``
    (every leaf ``[G, B, ...]``); a packed QTensor leaf gets a
    ``{"codes", "scales"}`` pair, both with its key's spec."""
    from repro_torch.core.qtensor import QTensor

    def leaf_spec(name: str, ndim: int) -> tuple:
        axes = ("layers",) + _CACHE_AXES.get(name, (None,) * ndim)
        axes = axes[:ndim] + (None,) * (ndim - len(axes))
        return tuple(rules.get(a) if a is not None else None for a in axes)

    out = {}
    for pos, sub in cache_tree.items():
        out[pos] = {}
        for name, leaf in sub.items():
            if isinstance(leaf, QTensor):
                out[pos][name] = {
                    "codes": leaf_spec(name, leaf.codes.ndim),
                    "scales": leaf_spec(name, leaf.scales.ndim)}
            else:
                out[pos][name] = leaf_spec(name, leaf.ndim)
    return out


def abstract_params(cfg: ModelConfig):
    """The Model of ``cfg`` on the ``meta`` device: shapes and dtypes."""
    from repro_torch.models.model import Model

    return Model(cfg, device="meta")


def abstract_train_state(cfg: ModelConfig, ocfg, ccfg) -> dict:
    """``train.init_train_state``'s tree on the ``meta`` device."""
    from repro_torch.optim import adamw
    from repro_torch.optim.compress import init_residuals

    del ocfg   # AdamW's state needs no config
    model = abstract_params(cfg)
    return {"params": model, "opt": adamw.init_state(model),
            "residuals": init_residuals(model, ccfg, len(cfg.pattern))}


def _sanitized(named: dict, specs: dict, mesh) -> dict:
    return {n: (None if s is None else
                named_sharding(mesh, tuple(named[n].shape), s))
            for n, s in specs.items()}


def train_state_specs(cfg: ModelConfig, ocfg, ccfg, mesh, rules):
    """(shardings, specs) of the whole train state (the reference's
    ``train_state_sds``): moments follow the parameter specs (they are
    elementwise), residuals too, and a ``None`` residual stays ``None``.
    ``specs`` are the rules' raw specs; ``shardings`` the sanitized
    :class:`NamedSharding` s on ``mesh``, in the same tree."""
    st = abstract_train_state(cfg, ocfg, ccfg)
    named = dict(st["params"].named_parameters())
    pspecs = param_specs(named, rules)
    rspecs = {n: None if r is None else pspecs[n]
              for n, r in st["residuals"].items()}
    specs = {"params": pspecs,
             "opt": {"mu": pspecs, "nu": pspecs, "step": ()},
             "residuals": rspecs}
    psh = _sanitized(named, pspecs, mesh)
    shardings = {"params": psh,
                 "opt": {"mu": psh, "nu": psh,
                         "step": NamedSharding(mesh, ())},
                 "residuals": {n: None if s is None else psh[n]
                               for n, s in rspecs.items()}}
    return shardings, specs


def params_specs(cfg: ModelConfig, mesh, rules):
    """(shardings, specs) of the parameters (``params_sds``)."""
    named = dict(abstract_params(cfg).named_parameters())
    specs = param_specs(named, rules)
    return _sanitized(named, specs, mesh), specs


def caches_specs(cfg: ModelConfig, batch: int, max_seq: int, mesh, rules, *,
                 quantized_kv: bool = False):
    """(shardings, specs) of ``models.init_caches`` (``caches_sds``)."""
    from repro_torch.core.qtensor import QTensor
    from repro_torch.models.model import init_caches

    ct = init_caches(cfg, batch, max_seq, quantized_kv=quantized_kv,
                     device="meta")
    specs = cache_specs(ct, rules)
    shardings = {}
    for pos, sub in ct.items():
        shardings[pos] = {}
        for name, leaf in sub.items():
            sp = specs[pos][name]
            if isinstance(leaf, QTensor):
                shardings[pos][name] = {
                    k: named_sharding(mesh, tuple(getattr(leaf, k).shape),
                                      sp[k]) for k in ("codes", "scales")}
            else:
                shardings[pos][name] = named_sharding(mesh, tuple(leaf.shape),
                                                      sp)
    return shardings, specs


def _counts_divide(cfg: ModelConfig, kind: str, m: int) -> bool:
    """The head counts a split kind also needs to divide (a weight's width
    can divide where its heads do not: 24 heads of 128 at m = 16)."""
    if kind == "heads":
        return cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0
    if kind == "mlstm":
        return cfg.n_heads % m == 0
    return True


def split_plan(cfg: ModelConfig, placed: dict) -> dict:
    """What a model rank computes split, read from where the parameters
    lie: ``placed`` maps each parameter's name to its DTensor, or to the
    :class:`NamedSharding` it is placed on. Returns ``{"model": m, "kinds":
    {kind: split?}, "local": [names]}`` for the layer kinds ``cfg`` has
    (``models.sharding.SPLIT_KINDS``). A kind computes split when the
    model axis has more than one rank, a leaf of the kind is sharded over
    it and the kind's head counts divide it; the leaves of a split kind
    that are sharded over "model" are ``local`` (the sharded step keeps
    this rank's extent over the model axis, whole over the data axes). A
    kind that does not split gathers its leaves and computes whole."""
    from torch.distributed.tensor import DTensor, Shard

    m, kinds, on_model = 1, {}, []
    for n, x in placed.items():
        mesh = x.device_mesh if isinstance(x, DTensor) else x.mesh
        names = mesh.mesh_dim_names
        i = names.index("model") if "model" in names else None
        m = 1 if i is None else mesh.size(i)
        kind = leaf_kind(n, cfg)
        if kind is None:
            continue
        on = m > 1 and isinstance(x.placements[i], Shard)
        kinds[kind] = kinds.get(kind, False) or on
        if on:
            on_model.append((n, kind))
    kinds = {k: kinds[k] and _counts_divide(cfg, k, m) for k in SPLIT_KINDS
             if k in kinds}
    return dict(model=m, kinds=kinds,
                local=sorted(n for n, k in on_model if kinds[k]))


def split_text(plan: dict) -> str:
    """``split heads ff ...; whole ...``: the kinds a model rank computes
    split and those it computes whole (every kind whole on m = 1)."""
    split = " ".join(k for k, v in plan["kinds"].items() if v)
    whole = " ".join(k for k, v in plan["kinds"].items() if not v)
    return (f"model axis {plan['model']}: split {split or '(none)'}; "
            f"whole {whole or '(none)'}")


# ---------------------------------------------------------------------------
# DTensor plumbing
# ---------------------------------------------------------------------------
def _local(full: torch.Tensor, mesh, placements, dims=None) -> torch.Tensor:
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    out = full
    for i, p in enumerate(placements):
        if not isinstance(p, Shard) or (
                dims is not None and mesh.mesh_dim_names[i] not in dims):
            continue
        n = mesh.size(i)
        if out.shape[p.dim] % n:
            raise ValueError(f"dim {p.dim} of {tuple(full.shape)} does not "
                             f"divide over {n} ranks")
        out = out.chunk(n, dim=p.dim)[coord[i]]
    return out


def local_slice(full: torch.Tensor, sharding, dims=None) -> torch.Tensor:
    """This rank's part of ``full`` (a view) on ``sharding`` (a
    :class:`NamedSharding` or a DTensor to match): split along each Shard
    dim in mesh-dim order, as DTensor lays shards out; with ``dims`` (mesh
    axis names) only along the shards of those axes."""
    from torch.distributed.tensor import DTensor

    if isinstance(sharding, DTensor):
        return _local(full, sharding.device_mesh, sharding.placements, dims)
    return _local(full, sharding.mesh, sharding.placements, dims)


def shard_tensor(full: torch.Tensor, sharding: NamedSharding,
                 device=None):
    """A DTensor on ``sharding`` holding this rank's slice of ``full``
    (copied unless the slice is all of it, so ``full`` can be freed). A
    ``full`` on the ``meta`` device is a zero tensor's shape: the slice is
    made as zeros on ``device``, the whole never exists."""
    from torch.distributed.tensor import DTensor

    loc = local_slice(full.detach(), sharding)
    if full.device.type == "meta":
        loc = torch.zeros(loc.shape, dtype=loc.dtype, device=device)
    else:
        loc = loc.contiguous() if loc.numel() == full.numel() else loc.clone()
    return DTensor.from_local(loc, sharding.mesh, sharding.placements,
                              run_check=False)


def gather_full(x, leg: str = "gather_full", dims=None) -> torch.Tensor:
    """The full tensor of a DTensor on every rank (all-gathers over each
    sharded mesh dim, innermost first); with ``dims`` (mesh axis names)
    over those axes only, the others' shards kept. A plain tensor
    passes."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return x
    out = x.to_local()
    mesh = x.device_mesh
    for i in reversed(range(mesh.ndim)):
        p = x.placements[i]
        if not isinstance(p, Shard) or mesh.size(i) == 1 or (
                dims is not None and mesh.mesh_dim_names[i] not in dims):
            continue
        moved = out.movedim(p.dim, 0)
        got = M.all_gather(moved, mesh.get_group(i), leg=leg)
        out = got.movedim(0, p.dim)
    return out.contiguous()


def is_owner(x) -> bool:
    """Whether this rank holds the copy of ``x``'s shard that counts once
    in a sum over the mesh: coordinate 0 on every replicated mesh dim. A
    plain tensor is owned."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return True
    coord = x.device_mesh.get_coordinate()
    return all(c == 0 for c, p in zip(coord, x.placements)
               if isinstance(p, Replicate))


def _module_slots(model: nn.Module) -> dict:
    """name -> (module, attribute) of every parameter."""
    out = {}
    for mod_name, mod in model.named_modules():
        for attr, p in mod._parameters.items():
            if p is not None:
                out[f"{mod_name}.{attr}" if mod_name else attr] = (mod, attr)
    return out


def set_params(model: nn.Module, tensors: dict) -> dict:
    """Swap the named parameters of ``model`` for ``tensors`` (plain tensors
    or Parameters) and return the ones they replace."""
    slots = _module_slots(model)
    old = {}
    for name, t in tensors.items():
        mod, attr = slots[name]
        old[name] = mod._parameters[attr]
        mod._parameters[attr] = t
    return old


def _shard_params(model: nn.Module, shardings: dict) -> None:
    new = {}
    for name, p in model.named_parameters():
        new[name] = nn.Parameter(shard_tensor(p.data, shardings[name]),
                                 requires_grad=p.requires_grad)
    set_params(model, new)


def shard_state(state, shardings: dict):
    """Place a train state ``{"params": Model, "opt", "residuals"}`` (or a
    ``Model`` alone, with ``{name: NamedSharding}``) on the mesh IN PLACE:
    each tensor with a sharding becomes a DTensor holding its local slice
    (parameters stay Parameters with their ``requires_grad``; moments and
    residuals on the ``meta`` device become this rank's zeros on the
    parameters' device); ``None`` residuals and the step stay as they are.
    Returns ``state``."""
    if isinstance(state, nn.Module):
        _shard_params(state, shardings)
        return state
    _shard_params(state["params"], shardings["params"])
    dev = state["params"].embed.to_local().device
    for key in ("mu", "nu"):
        d = state["opt"][key]
        for name in d:
            d[name] = shard_tensor(d[name], shardings["opt"][key][name], dev)
    res = state["residuals"]
    for name, r in res.items():
        if r is not None:
            res[name] = shard_tensor(r, shardings["residuals"][name], dev)
    return state


def roundtrip_gathered(cfg: ModelConfig, ccfg, mesh, rules) -> list:
    """The compressed leaves of ``cfg``'s train state whose gradient round
    trip cannot run shard by shard on ``mesh`` under ``rules``: the last
    dim is split and its local width is not a multiple of ``ccfg.block``
    (``train.step.ef_local_split`` gathers them). Shapes only."""
    from repro_torch.optim.compress import compressed_leaves

    st = abstract_train_state(cfg, None, ccfg)
    named = dict(st["params"].named_parameters())
    shardings, _ = train_state_specs(cfg, None, ccfg, mesh, rules)
    sizes = mesh_shape(mesh)
    out = []
    for n in compressed_leaves(named, st["residuals"], ccfg,
                               len(cfg.pattern)):
        shape, spec = named[n].shape, shardings["params"][n].spec
        split = math.prod(sizes[a] for a in _names(spec[-1]))
        if split > 1 and (shape[-1] // split) % ccfg.block:
            out.append(n)
    return out
