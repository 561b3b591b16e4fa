"""Carry the JAX reference's parameters and train state into the port, and
name the port's parameters by the reference's leaf paths.

``params_from_jax(np_tree, cfg, device)`` takes the tree of
``repro.models.init_params(cfg, PRNGKey(0))`` with every leaf converted to
a numpy array (the caller does the conversion, so this module never imports
JAX) and returns a :class:`~repro_torch.models.model.Model` holding the same
numbers. ``train_state_from_jax`` does the same for a whole train state
``{"params", "opt": {"mu", "nu", "step"}, "residuals"}``. Both packages
then compute the same function, which is what the parity tests compare.

The reference stacks the layers' leaves ``[G, ...]`` under
``blocks/b<i>/...``, one subtree per pattern position ``i``; the port
keeps one tensor per layer, named ``blocks.<l>.<...>`` by
``Model.named_parameters()``, layer ``l = g * P + i`` for group ``g`` of a
pattern of length ``P``. The encoder's layers are stacked
``[encoder_layers, ...]`` straight under ``encoder/blocks/...`` (no
``b<i>`` level): ``encoder.blocks.<l>.<...>`` is index ``l`` there. :func:`reference_path` maps a port name onto the
reference's path and group, and :func:`reference_layout` regroups a flat name -> tensor dict
(the parameters, their moments, residuals or gradients) into the
reference's leaves, each the list of its per-layer parts. The checkpoint
writes that layout, and gradient compression reads each leaf's size from
it, so both act on exactly the leaves the reference acts on.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model

_BLOCK = re.compile(r"^blocks\.(\d+)\.(.+)$")
_ENC_BLOCK = re.compile(r"^encoder\.blocks\.(\d+)\.(.+)$")


def reference_path(name: str, pattern_len: int
                   ) -> tuple[tuple[str, ...], int | None]:
    """Port parameter name -> (reference leaf path, group index or None)
    for a pattern of ``pattern_len`` positions: ``blocks.3.mixer.wq`` ->
    (("blocks", "b0", "mixer", "wq"), 3) for P = 1 and (("blocks", "b1",
    "mixer", "wq"), 1) for P = 2; ``encoder.blocks.3.ff.up`` -> (("encoder",
    "blocks", "ff", "up"), 3) for any P."""
    m = _BLOCK.match(name)
    if m:
        g, i = divmod(int(m[1]), pattern_len)
        return ("blocks", f"b{i}", *m[2].split(".")), g
    m = _ENC_BLOCK.match(name)
    if m:
        return ("encoder", "blocks", *m[2].split(".")), int(m[1])
    return tuple(name.split(".")), None


def is_layer_dict(d: dict) -> bool:
    """True for a flat dict keyed by the port's parameter names."""
    return bool(d) and all(isinstance(k, str) for k in d) and any(
        "." in k for k in d)


class Stacked(list):
    """The per-layer parts of one stacked reference leaf, in layer order."""


def reference_layout(named: dict, pattern_len: int
                     ) -> dict[tuple, object]:
    """Flat ``{port name: tensor}`` -> ``{reference path: leaf}``: the
    tensor itself for an unstacked leaf, a :class:`Stacked` list of the
    groups' tensors for a stacked one (``pattern_len``: the pattern's
    positions, ``len(cfg.pattern)``)."""
    groups: dict[tuple, dict[int, object]] = {}
    for name, t in named.items():
        path, layer = reference_path(name, pattern_len)
        groups.setdefault(path, {})[-1 if layer is None else layer] = t
    out = {}
    for path, parts in groups.items():
        idx = sorted(parts)
        if idx != [-1] and idx != list(range(len(idx))):
            raise ValueError(f"{'/'.join(path)}: groups {idx} are not "
                             "0..n-1")
        out[path] = parts[-1] if idx == [-1] else Stacked(
            parts[i] for i in idx)
    return out


def reference_numel(named: dict, pattern_len: int) -> dict[str, int]:
    """Each name's element count in the reference's (stacked) leaf."""
    sizes = {}
    for path, leaf in reference_layout(named, pattern_len).items():
        parts = leaf if isinstance(leaf, Stacked) else [leaf]
        sizes[path] = sum(int(p.numel()) for p in parts if p is not None)
    return {name: sizes[reference_path(name, pattern_len)[0]]
            for name in named}


def params_from_jax(np_tree: dict, cfg: ModelConfig, device="cuda") -> Model:
    """Reference tree (stacked ``blocks/b<i>/...`` leaves ``[G, ...]``) ->
    per-layer ``Model``; each tensor keeps its parameter's dtype (the MoE
    router is f32 in a bf16 model, as the reference's)."""
    model = Model(cfg, device)
    P = len(cfg.pattern)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(_leaf(np_tree, name, tuple(p.shape), P).to(p.dtype))
    return model


def _leaf(np_tree: dict, name: str, shape: tuple,
          pattern_len: int) -> torch.Tensor:
    path, layer = reference_path(name, pattern_len)
    a = np_tree
    for k in path:
        a = a[k]
    if a is None:
        return None
    a = np.array(a if layer is None else a[layer], dtype=np.float32)
    if tuple(a.shape) != shape:
        raise ValueError(f"{name}: shape {a.shape} != {shape}")
    return torch.from_numpy(a)


def train_state_from_jax(np_state: dict, cfg: ModelConfig, device="cuda"):
    """A reference train state (every leaf a numpy array, ``None``
    residuals kept) -> the port's ``{"params": Model (gradients on),
    "opt": {"mu", "nu", "step"}, "residuals"}``, moments and residuals
    keyed by parameter name."""
    model = params_from_jax(np_state["params"], cfg, device)
    model.requires_grad_(True)
    opt = np_state["opt"]
    return {"params": model,
            "opt": {"mu": named_from_jax(opt["mu"], model),
                    "nu": named_from_jax(opt["nu"], model),
                    "step": torch.tensor(int(np.asarray(opt["step"])),
                                         dtype=torch.int32,
                                         device=model.device)},
            "residuals": named_from_jax(np_state["residuals"], model)}


def named_from_jax(np_tree: dict, model: Model) -> dict:
    """A params-shaped reference tree of numpy f32 leaves (moments,
    residuals, gradients; ``None`` kept) -> ``{parameter name: f32
    tensor}`` on the model's device."""
    out = {}
    P = len(model.cfg.pattern)
    for name, p in model.named_parameters():
        t = _leaf(np_tree, name, tuple(p.shape), P)
        out[name] = None if t is None else t.to(model.device)
    return out


def recurrent_caches_from_jax(np_caches: dict, cfg: ModelConfig,
                              device="cuda") -> dict:
    """The recurrent entries of a reference cache tree (``{"b<i>": {leaf:
    [G, B, ...]}}``, every leaf a numpy array) -> the same dict of tensors
    of the same dtypes on ``device``: the state the port's
    :func:`~repro_torch.models.model.init_caches` lays out at the mamba,
    mLSTM and sLSTM positions. Attention positions are left out."""
    return {f"b{i}": {name: torch.from_numpy(np.array(leaf)).to(device)
                      for name, leaf in np_caches[f"b{i}"].items()}
            for i in cfg.recurrent_positions}


def quantized_weight_from_jax(codes_or_words, scales, *, packed: bool,
                              device="cuda"):
    """The reference's ``quantize_weight`` outputs as numpy arrays (codes
    uint8 / uint16 ``[K, N]``, or packed words uint32 ``[K, W]``; scales
    f32 ``[K/block, N]``) -> the port's tensors of the same dtypes and bits
    on ``device``, ready for ``kernels.f2p_matmul.dequant_matmul``."""
    c = np.array(codes_or_words)          # a writable copy for torch
    want = (np.uint32,) if packed else (np.uint8, np.uint16)
    if c.dtype not in want:
        raise TypeError(f"{'words' if packed else 'codes'} must be "
                        f"{'/'.join(np.dtype(d).name for d in want)}, got "
                        f"{c.dtype}")
    # through a signed view of the same width: torch's unsigned 16/32-bit
    # types have few operations, their bits travel unchanged
    signed = {np.dtype(np.uint16): (np.int16, torch.uint16),
              np.dtype(np.uint32): (np.int32, torch.uint32)}
    if c.dtype in signed:
        view, tdt = signed[c.dtype]
        t = torch.from_numpy(c.view(view)).to(device).view(tdt)
    else:
        t = torch.from_numpy(c).to(device)
    s = torch.from_numpy(np.array(scales, np.float32)).to(device)
    return t, s


# ---------------------------------------------------------------------------
# The reference's stacked parameter tree (the FL path's layout)
# ---------------------------------------------------------------------------
def stacked_params(model: Model) -> dict:
    """The model's parameters in the reference's tree: nested dicts by
    reference path, each stacked leaf one ``[G, ...]`` tensor (a copy),
    each unstacked leaf a copy of its tensor. The FL client computes its
    deltas, residuals and updates on this tree, so the ``min_size`` test,
    the wire-shrink test, the exact path's per-leaf grid and the fault
    injector's leaf draw act on the reference's leaves."""
    out: dict = {}
    for path, leaf in reference_layout(dict(model.named_parameters()),
                                       len(model.cfg.pattern)).items():
        t = (torch.stack([p.detach() for p in leaf])
             if isinstance(leaf, Stacked) else leaf.detach().clone())
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def params_tree_from_jax(np_tree, device="cuda"):
    """A reference parameter tree (nested dicts of numpy arrays, stacked
    ``blocks/b<i>/...`` leaves kept stacked) -> the same tree of f32 tensors
    on ``device``: the FL drivers' parameters."""
    if isinstance(np_tree, dict):
        return {k: params_tree_from_jax(v, device) for k, v in np_tree.items()}
    if np_tree is None:
        return None
    return torch.from_numpy(np.array(np_tree, np.float32)).to(device)


def update_from_jax(np_tree, device="cpu"):
    """A reference wire update (nested dicts of numpy arrays; each QTensor
    leaf given as its parts ``(codes, scales, fmt, block, shape, packed)``
    with ``fmt`` a format name or an F2PFormat) -> the port's update tree
    on ``device``, the same bytes in every buffer
    (``QTensor.from_parts`` validates each)."""
    from repro_torch.core.formats import named_format
    from repro_torch.core.qtensor import QTensor

    if isinstance(np_tree, dict):
        return {k: update_from_jax(v, device) for k, v in np_tree.items()}
    if isinstance(np_tree, tuple):
        codes, scales, fmt, block, shape, packed = np_tree
        if isinstance(fmt, str):
            fmt = named_format(fmt)
        return QTensor.from_parts(_array_to_torch(codes, device),
                                  _array_to_torch(scales, device), fmt,
                                  block, shape, packed)
    return _array_to_torch(np_tree, device)


def _array_to_torch(a, device) -> torch.Tensor:
    """A numpy array -> a tensor of the same dtype and bytes on ``device``."""
    return torch.from_numpy(np.array(a)).to(device)
