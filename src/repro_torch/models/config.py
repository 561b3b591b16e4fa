"""Model configuration (port of ``repro.models.config``): the attention
families, dense and MoE.

A model is a stack of ``n_layers`` blocks arranged as repetitions of a
``pattern`` (a tuple of :class:`BlockSpec`); layer ``l`` is pattern
position ``l % len(pattern)`` of group ``l // len(pattern)``. This slice of
the port serves attention mixers with dense (SwiGLU) or MoE FFs and RoPE
positions. Any other mixer, a frontend, an encoder, another position
scheme or tied embeddings raise ``NotImplementedError`` naming their
ROADMAP item. Fields the port does not read (SSM, xLSTM, encoder,
frontend, position schemes and the ``opt_*`` knobs) are left out.
``remat`` is kept: the train forward recomputes each block in the
backward (``torch.utils.checkpoint``) as the reference rematerializes its
scan body. ``fsdp`` is kept because the MoE configs set it; on one card it
changes nothing (sharding is ROADMAP A12).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

Mixer = Literal["attn", "mamba", "mlstm", "slstm"]
FF = Literal["dense", "moe", "none"]

# the ROADMAP item that ports each mixer the port does not have yet
_MIXER_ITEM = {"mamba": "A13d", "mlstm": "A13e", "slstm": "A13e"}


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

    # --- the reference's frontends, encoder and position schemes; only
    #     the defaults are ported (A13b, A13e, A13f) ---
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
        for b in self.pattern:
            if b.mixer != "attn":
                raise NotImplementedError(
                    f"{self.name}: the {b.mixer} mixer is not ported "
                    f"(ROADMAP {_MIXER_ITEM.get(b.mixer, 'A13')})")
            if b.ff not in ("dense", "moe"):
                raise NotImplementedError(
                    f"{self.name}: an attention block without an FF is "
                    "ported with the xLSTM family (ROADMAP A13e)")
        for field, default, item in (
                ("frontend", "none", "A13b / A13f"),
                ("encoder_layers", 0, "A13f"),
                ("pos", "rope", "A13e / A13f"),
                ("tie_embeddings", False, "A13e")):
            if getattr(self, field) != default:
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
    def attn_positions(self) -> tuple[int, ...]:
        return tuple(i for i, b in enumerate(self.pattern) if b.mixer == "attn")

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            self.dtype]

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), the
        reference's formula for the ported block kinds (which, as the
        reference's, leaves out the final norm's ``d_model``)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        hd, H, K = self.head_dim, self.n_heads, self.n_kv_heads
        total = 2 * V * D                # embed, lm_head
        attn = D * hd * (H + 2 * K) + H * hd * D
        ff = {"dense": 3 * D * F,
              "moe": ((self.n_experts + self.n_shared_experts) * 3 * D * F
                      + D * self.n_experts)}
        for b in self.pattern:
            total += (attn + ff[b.ff] + 2 * D) * self.n_groups
        return total


def dense_pattern(moe_every: int = 0) -> tuple[BlockSpec, ...]:
    """Dense transformer, optionally MoE every `moe_every` layers."""
    if moe_every <= 1 and moe_every != 0:
        return (BlockSpec("attn", "moe"),)
    if moe_every == 0:
        return (BlockSpec("attn", "dense"),)
    return tuple(BlockSpec("attn", "moe" if (i % moe_every == moe_every - 1)
                           else "dense") for i in range(moe_every))
