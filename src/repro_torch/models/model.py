"""The llama-dense model: parameters, caches, the train forward, prefill and
decode (port of ``repro.models.model``).

Parameters live in an ``nn.Module`` tree with one :class:`Block` per layer
(the reference stacks them ``[G, ...]`` and scans; here ``lax.scan`` over
layers becomes a Python loop over ``model.blocks``). Every weight keeps the
reference's ``[in, out]`` layout (``x @ w``) and its truncated-normal(0.02)
init; norms start at one.

Caches are ``{"k", "v"}`` with a leading layer axis ``[L, B, S, K, hd]``
(the reference's ``{"b0": {...}}`` level collapses: the llama-dense pattern
has one attention position). Paged decode instead binds the pool slabs
``[L, P, T, K, W]`` and a ``[B, max_pages]`` page table; every cache and
slab write happens in place.

Parameters are created with ``requires_grad=False``: serving runs under
``torch.inference_mode``, and training (``repro_torch.train``) turns the
gradients on.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.f2p import F2PFormat
from repro_torch.models import attention as A
from repro_torch.models.common import (rms_norm, softmax_cross_entropy,
                                      swiglu, truncnorm_init)
from repro_torch.models.config import ModelConfig


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        D, hd, H, K = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        dt = cfg.torch_dtype
        self.wq = _param((D, H * hd), dt, device)
        self.wk = _param((D, K * hd), dt, device)
        self.wv = _param((D, K * hd), dt, device)
        self.wo = _param((H * hd, D), dt, device)

    def weights(self) -> dict:
        return {"wq": self.wq, "wk": self.wk, "wv": self.wv, "wo": self.wo}


class FeedForward(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        D, F, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
        self.gate = _param((D, F), dt, device)
        self.up = _param((D, F), dt, device)
        self.down = _param((F, D), dt, device)

    def forward(self, x):
        return swiglu(x, self.gate, self.up, self.down)


class Block(nn.Module):
    """Pre-norm attention + SwiGLU block."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = cfg.torch_dtype
        self.norm1 = _param((cfg.d_model,), dt, device)
        self.mixer = Attention(cfg, device)
        self.norm2 = _param((cfg.d_model,), dt, device)
        self.ff = FeedForward(cfg, device)

    def forward(self, x, cfg: ModelConfig, *, mode, cache=None, pos_offset=0,
                pages=None):
        h = rms_norm(x, self.norm1, cfg.norm_eps)
        h, _ = A.attention_apply(self.mixer.weights(), h, cfg, mode=mode,
                                 cache=cache, pos_offset=pos_offset,
                                 pages=pages)
        x = x + h
        return x + self.ff(rms_norm(x, self.norm2, cfg.norm_eps))


class Model(nn.Module):
    """Parameters of a llama-dense model (allocated, not initialised)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        D, V, dt = cfg.d_model, cfg.vocab_size, cfg.torch_dtype
        self.embed = _param((V, D), dt, device)
        self.final_norm = _param((D,), dt, device)
        self.lm_head = _param((D, V), dt, device)
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Model:
    """Random weights from ``torch.Generator(device).manual_seed(seed)`` in
    the reference's layout and distribution: truncated normal(-2, 2) x 0.02
    for embed, lm_head and every projection, drawn in that order and layer
    by layer; ones for the norms."""
    device = torch.device(device)
    model = Model(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def fill(p: nn.Parameter):
        p.data.copy_(truncnorm_init(p.shape, p.dtype, gen, device))

    with torch.no_grad():
        fill(model.embed)
        fill(model.lm_head)
        model.final_norm.fill_(1.0)
        for blk in model.blocks:
            blk.norm1.fill_(1.0)
            blk.norm2.fill_(1.0)
            for w in (blk.mixer.wq, blk.mixer.wk, blk.mixer.wv, blk.mixer.wo,
                      blk.ff.gate, blk.ff.up, blk.ff.down):
                fill(w)
    return model


def kv_format(kv_policy=None) -> F2PFormat:
    """The quantized-KV format under ``kv_policy`` (a
    :class:`~repro_torch.autotune.policy.FormatPolicy` or None): the rule
    path is ``kv/b<i>`` per pattern position, as in the reference. The
    llama-dense pattern has one position, so ``kv/b0`` (or ``kv/*``) sets
    the format of every layer; no policy keeps ``attention.KV_FMT``."""
    if kv_policy is None:
        return A.KV_FMT
    fmt, _ = kv_policy.f2p_for("kv/b0", (A.KV_FMT, 0))
    return fmt


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, *,
                quantized_kv: bool = False, kv_policy=None,
                attn_kv: bool = True, device="cuda"):
    """KV caches ``{"k","v"}`` of shape ``[L, batch, max_seq, K, hd]``.

    ``attn_kv=False`` returns ``None``: the paged engine binds pool slabs
    instead, and no dense ``[batch, max_seq]`` row is allocated. Quantized
    caches are always bit-packed, in the format :func:`kv_format` picks
    from ``kv_policy``."""
    if not attn_kv:
        return None
    return A.init_cache(cfg, batch, max_seq, quantized_kv, cfg.torch_dtype,
                        torch.device(device), fmt=kv_format(kv_policy),
                        lead=(cfg.n_layers,))


def layer_cache(caches, i: int):
    """Layer ``i``'s ``{"k","v"}`` view of stacked caches or slabs (views
    share storage, so in-place writes land in the stack)."""
    from repro_torch.core.qtensor import QTensor

    def one(c):
        if isinstance(c, QTensor):
            return QTensor(c.codes[i], c.scales[i], c.fmt, c.block,
                           c.shape[1:], c.packed)
        return c[i]

    return {kv: one(caches[kv]) for kv in ("k", "v")}


def train_forward(model: Model, batch, cfg: ModelConfig | None = None):
    """batch: tokens ``[B, S]``, labels ``[B, S]`` (-1 = masked). Returns
    (loss, metrics): mean token CE + 0.01 x aux loss (0 for the dense
    stack), as the reference. With ``cfg.remat`` every block is recomputed
    in the backward (``torch.utils.checkpoint``), so only the block inputs
    stay alive between forward and backward."""
    from torch.utils.checkpoint import checkpoint

    cfg = cfg or model.cfg
    dev = model.device
    tokens = torch.as_tensor(batch["tokens"], device=dev).to(torch.int64)
    labels = torch.as_tensor(batch["labels"], device=dev).to(torch.int64)
    x = model.embed[tokens]
    for blk in model.blocks:
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(blk, x, cfg, mode="train", use_reentrant=False)
        else:
            x = blk(x, cfg, mode="train")
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    loss = softmax_cross_entropy(x @ model.lm_head, labels)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return loss + 0.01 * aux, {"ce_loss": loss, "aux_loss": aux}


@torch.inference_mode()
def prefill(model: Model, tokens: torch.Tensor, caches, last_index=None,
            cfg: ModelConfig | None = None):
    """Consume prompts ``[B, S]``: writes the caches in place and returns
    the last-token logits ``[B, V]`` (at ``last_index[b]`` when given, for
    bucket-padded prompts). ``cfg`` overrides ``model.cfg`` for serve-time
    switches such as ``fused_attention``."""
    cfg = cfg or model.cfg
    x = model.embed[tokens]
    for i, blk in enumerate(model.blocks):
        x = blk(x, cfg, mode="prefill", cache=layer_cache(caches, i),
                pos_offset=0)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    if last_index is not None:
        li = torch.as_tensor(last_index, device=x.device).to(torch.int64)
        x = x[torch.arange(x.shape[0], device=x.device), li][:, None]
    else:
        x = x[:, -1:]
    return (x @ model.lm_head)[:, 0]


@torch.inference_mode()
def decode_step(model: Model, token: torch.Tensor, pos, caches, pages=None,
                cfg: ModelConfig | None = None):
    """One decode step: token ``[B, 1]``; ``pos`` a scalar write index or a
    per-slot ``[B]`` vector. With ``pages`` (``[B, max_pages]`` int32) the
    caches are pool slabs attended in place through the page table.
    Returns logits ``[B, V]``; caches are updated in place."""
    cfg = cfg or model.cfg
    x = model.embed[token]
    for i, blk in enumerate(model.blocks):
        x = blk(x, cfg, mode="decode", cache=layer_cache(caches, i),
                pos_offset=pos, pages=pages)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return (x @ model.lm_head)[:, 0]
