"""Model configuration (port of ``repro.models.config``), llama-dense only.

The reference dataclass covers every assigned family; this slice of the
port serves the llama-dense pattern (GQA attention + SwiGLU FF, RoPE).
Any other mixer, FF kind or position scheme raises ``NotImplementedError``
(ROADMAP A13). Fields the port does not read (MoE, SSM, xLSTM, encoder,
position schemes, tied embeddings, sharding and the ``opt_*`` knobs) are
left out: positions are RoPE and the LM head is its own matrix. ``remat``
is kept: the train forward recomputes each block in the backward
(``torch.utils.checkpoint``) as the reference rematerializes its scan body.
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
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # decode attends the packed KV cache with the fused kernel instead of
    # dequantizing the whole cache each step (engages for packed caches)
    fused_attention: bool = False
    remat: bool = True                     # recompute each block in backward

    def __post_init__(self):
        if any(b != BlockSpec("attn", "dense") for b in self.pattern):
            raise NotImplementedError(
                f"{self.name}: only the llama-dense pattern (attn + dense FF) "
                "is ported; other families are ROADMAP A13")
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.name}: n_layers {self.n_layers} not a "
                             f"multiple of pattern {len(self.pattern)}")
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            self.dtype]

    def param_count(self) -> int:
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        hd, H, K = self.head_dim, self.n_heads, self.n_kv_heads
        total = 2 * V * D + D
        per = D * hd * (H + 2 * K) + H * hd * D + 3 * D * F + 2 * D
        return total + per * self.n_layers


def dense_pattern() -> tuple[BlockSpec, ...]:
    return (BlockSpec("attn", "dense"),)
