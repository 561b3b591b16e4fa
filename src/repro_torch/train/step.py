"""Train-step factory (port of ``repro.train.step``): loss + gradients +
F2P gradient compression + AdamW.

The train state is a plain dict, as in the reference:
``{"params": Model, "opt": {"mu", "nu", "step"}, "residuals"}``, moments
and residuals keyed by parameter name. The step runs eagerly (no
``torch.compile``) and updates the state IN PLACE: autograd writes each
parameter's ``.grad``, compression rewrites the gradients and residuals
where they lie (one launch of B5's round-trip mode for all compressed
leaves on the card) and AdamW updates parameters and moments leaf by
leaf. The compressed gradients stay in ``.grad`` until the next step
clears them.
"""
from __future__ import annotations

import torch

from repro_torch.models import init_params, train_forward
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.optim.compress import (CompressionConfig, compress_decompress,
                                        init_residuals)


def init_train_state(cfg: ModelConfig, ocfg: adamw.AdamWConfig,
                     ccfg: CompressionConfig, seed: int = 0, device="cuda"):
    """Fresh state: random parameters from ``torch.Generator`` ``seed``
    (gradients on), zero moments, zero residuals."""
    del ocfg   # the reference's signature; AdamW's state needs no config
    model = init_params(cfg, seed=seed, device=device)
    model.requires_grad_(True)
    return {"params": model, "opt": adamw.init_state(model),
            "residuals": init_residuals(model, ccfg, len(cfg.pattern))}


def loss_and_grads(model, batch, cfg: ModelConfig):
    """Forward + backward: (loss, metrics, name -> gradient). Earlier
    gradients are dropped first, so ``.grad`` holds this batch's only. A
    parameter the batch does not reach (``vision_proj`` of a text-only
    batch) gets a zero gradient, as under ``jax.grad``, so AdamW's weight
    decay still moves it as the reference's does."""
    for p in model.parameters():
        p.grad = None
    loss, metrics = train_forward(model, batch, cfg)
    loss.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = {n: p.grad for n, p in model.named_parameters()}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(cfg: ModelConfig, ocfg: adamw.AdamWConfig,
                    ccfg: CompressionConfig):
    def train_step(state, batch):
        model = state["params"]
        loss, metrics, grads = loss_and_grads(model, batch, cfg)
        compress_decompress(grads, state["residuals"], ccfg,
                            len(cfg.pattern))
        _, _, om = adamw.apply_updates(model, grads, state["opt"], ocfg)
        return state, dict(metrics, loss=loss, **om)

    return train_step
