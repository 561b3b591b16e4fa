"""AdamW from scratch (port of ``repro.optim.adamw``).

State layout mirrors the parameters: ``{"mu", "nu"}`` are dicts of f32
tensors keyed by parameter name and ``"step"`` is a 0-d int32 tensor on the
parameters' device, so the learning rate, bias corrections and clip scale
stay on the device and a step needs no host sync.

The update runs one leaf at a time and IN PLACE (JAX returns new trees):
at llama3.2-3b's width mu and nu hold 28.9 GB, and an update that
allocated f32 temporaries for every leaf at once would not fit beside
them. Each leaf's arithmetic is the reference's, op for op in f32.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def named_params(params) -> dict:
    """A ``Model`` -> its ``named_parameters()`` dict; a dict passes."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Warmup then cosine decay to ``min_lr_ratio``, in f32 (``step`` an int
    or an int tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_state(params) -> dict:
    named = named_params(params)
    dev = next(iter(named.values())).device
    zeros = lambda: {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in named.items()}
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict) -> torch.Tensor:
    total = None
    for x in tree.values():
        s = x.to(torch.float32).square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads: dict, state: dict, cfg: AdamWConfig, *,
                  gnorm: torch.Tensor | None = None):
    """Update ``params`` (a ``Model`` or name -> tensor dict), ``state``'s
    moments and its step IN PLACE from ``grads`` (name -> tensor). Returns
    (params, state, metrics) with ``grad_norm`` and ``lr`` as 0-d device
    tensors. ``gnorm`` overrides :func:`global_norm` of ``grads``: the
    sharded step passes the norm of the whole gradient, its leaves being
    local shards."""
    named = named_params(params)
    if set(grads) != set(named):
        raise ValueError("gradient names differ from the parameters'")
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    for name, p in named.items():
        mu, nu = state["mu"][name], state["nu"][name]
        g = grads[name].to(torch.float32) * scale
        mu.mul_(b1).add_(g * (1 - b1))
        g2 = g * (1 - b2)
        nu.mul_(b2).add_(g2.mul_(g))
        del g, g2
        delta = mu / bc1
        den = (nu / bc2).sqrt_().add_(cfg.eps)
        delta.div_(den)
        del den
        p32 = p.to(torch.float32)
        delta.add_(cfg.weight_decay * p32)
        p.copy_(p32 - delta.mul_(lr))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
