"""Carry the JAX reference's parameters into the port.

``params_from_jax(np_tree, cfg, device)`` takes the tree of
``repro.models.init_params(cfg, PRNGKey(0))`` with every leaf converted to
a numpy array (the caller does the conversion, so this module never imports
JAX) and returns a :class:`~repro_torch.models.model.Model` holding the same
numbers. Both packages then compute the same function, which is what the
parity tests compare.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model


def params_from_jax(np_tree: dict, cfg: ModelConfig, device="cuda") -> Model:
    """Reference tree (stacked ``blocks/b0/...`` leaves ``[G, ...]``) ->
    per-layer ``Model``."""
    model = Model(cfg, device)

    def put(p, arr):
        a = np.array(arr, dtype=np.float32)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"shape {a.shape} != {tuple(p.shape)}")
        p.data.copy_(torch.from_numpy(a).to(p.dtype))

    with torch.no_grad():
        put(model.embed, np_tree["embed"])
        put(model.final_norm, np_tree["final_norm"])
        put(model.lm_head, np_tree["lm_head"])
        blocks = np_tree["blocks"]["b0"]
        for i, blk in enumerate(model.blocks):
            put(blk.norm1, blocks["norm1"][i])
            put(blk.norm2, blocks["norm2"][i])
            for name in ("wq", "wk", "wv", "wo"):
                put(getattr(blk.mixer, name), blocks["mixer"][name][i])
            for name in ("gate", "up", "down"):
                put(getattr(blk.ff, name), blocks["ff"][name][i])
    return model
