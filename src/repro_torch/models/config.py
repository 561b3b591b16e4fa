"""Model configuration (port of ``repro.models.config``): the attention
families (dense and MoE), the mamba hybrid and xLSTM.

A model is a stack of ``n_layers`` blocks arranged as repetitions of a
``pattern`` (a tuple of :class:`BlockSpec`); layer ``l`` is pattern
position ``l % len(pattern)`` of group ``l // len(pattern)``. Every mixer
of the reference is ported (attention, mamba, mLSTM, sLSTM), with dense
(SwiGLU), MoE or no FF, RoPE or no positions and tied or separate
embeddings. A frontend, an encoder or sinusoidal positions raise
``NotImplementedError`` naming their ROADMAP item; their fields keep
only the defaults, and the ``opt_*`` knobs are left out. ``remat`` is
kept: the train forward recomputes each block in the backward
(``torch.utils.checkpoint``) as the reference rematerializes its scan
body. ``fsdp`` is kept because the MoE configs set it; on one card it
changes nothing (sharding is ROADMAP A12).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

Mixer = Literal["attn", "mamba", "mlstm", "slstm"]
FF = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: Mixer = "attn"
    ff: FF = "dense"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    pattern: tuple[BlockSpec, ...] = (BlockSpec(),)

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 1
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # --- SSM (mamba) ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2

    # --- xLSTM ---
    mlstm_expand: int = 2

    # --- the reference's frontends and encoder keep their defaults (A13b,
    #     A13f); positions are RoPE or none ---
    encoder_layers: int = 0
    frontend: Literal["none", "audio", "vision"] = "none"
    pos: Literal["rope", "sinusoidal", "none"] = "rope"
    tie_embeddings: bool = False

    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # decode attends the packed KV cache with the fused kernel instead of
    # dequantizing the whole cache each step (engages for packed caches)
    fused_attention: bool = False

    # --- distribution knobs: fsdp shards the parameters over the data
    #     axis in the reference; the port runs on one card, where it is
    #     inert until ROADMAP A12 ---
    fsdp: bool = False
    remat: bool = True                     # recompute each block in backward

    def __post_init__(self):
        for field, bad, item in (
                ("frontend", self.frontend != "none", "A13b / A13f"),
                ("encoder_layers", self.encoder_layers != 0, "A13f"),
                ("pos", self.pos == "sinusoidal", "A13f")):
            if bad:
                raise NotImplementedError(
                    f"{self.name}: {field}={getattr(self, field)!r} is not "
                    f"ported (ROADMAP {item})")
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.name}: n_layers {self.n_layers} not a "
                             f"multiple of pattern {len(self.pattern)}")
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:              # mamba inner dim
        return self.ssm_expand * self.d_model

    @property
    def attn_positions(self) -> tuple[int, ...]:
        return tuple(i for i, b in enumerate(self.pattern) if b.mixer == "attn")

    @property
    def recurrent_positions(self) -> tuple[int, ...]:
        """Pattern positions whose mixer carries per-sequence state."""
        return tuple(i for i, b in enumerate(self.pattern) if b.mixer != "attn")

    @property
    def is_subquadratic(self) -> bool:
        """True if the stack contains any non-attention mixer (SSM/xLSTM)."""
        return any(b.mixer != "attn" for b in self.pattern)

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            self.dtype]

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), the
        reference's formula (which leaves out the final norm's ``d_model``
        and counts a norm2 for blocks without an FF)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        hd, H, K = self.head_dim, self.n_heads, self.n_kv_heads
        di, E = self.d_inner, self.mlstm_expand
        total = V * D                    # embed
        if not self.tie_embeddings:
            total += D * V               # lm_head
        per = {"attn": D * hd * (H + 2 * K) + H * hd * D,
               "mamba": (D * 2 * di + di * D
                         + di * (self.ssm_conv + 2 * self.ssm_state + 2)
                         + di * self.ssm_state),
               "mlstm": D * 3 * E * D + E * D * D + 4 * E * D,
               "slstm": 4 * (D * D + D * (D // max(H, 1))) + 4 * D}
        ff = {"dense": 3 * D * F,
              "moe": ((self.n_experts + self.n_shared_experts) * 3 * D * F
                      + D * self.n_experts),
              "none": 0}
        for b in self.pattern:
            total += (per[b.mixer] + ff[b.ff] + 2 * D) * self.n_groups
        return total


def dense_pattern(moe_every: int = 0) -> tuple[BlockSpec, ...]:
    """Dense transformer, optionally MoE every `moe_every` layers."""
    if moe_every <= 1 and moe_every != 0:
        return (BlockSpec("attn", "moe"),)
    if moe_every == 0:
        return (BlockSpec("attn", "dense"),)
    return tuple(BlockSpec("attn", "moe" if (i % moe_every == moe_every - 1)
                           else "dense") for i in range(moe_every))


def jamba_pattern() -> tuple[BlockSpec, ...]:
    """Jamba: 1 attention per 8 layers (1:7), MoE every other layer."""
    return tuple(BlockSpec("attn" if i == 4 else "mamba",
                           "moe" if i % 2 == 1 else "dense")
                 for i in range(8))


def xlstm_pattern() -> tuple[BlockSpec, ...]:
    """xLSTM: three mLSTM blocks then one sLSTM (3:1 at 125M scale); the
    blocks carry their own projections and no FF (d_ff = 0)."""
    return (BlockSpec("mlstm", "none"), BlockSpec("mlstm", "none"),
            BlockSpec("mlstm", "none"), BlockSpec("slstm", "none"))
