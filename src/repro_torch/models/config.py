"""Model configuration (port of ``repro.models.config``): one dataclass
for every architecture of the reference.

A model is a stack of ``n_layers`` blocks arranged as repetitions of a
``pattern`` (a tuple of :class:`BlockSpec`); layer ``l`` is pattern
position ``l % len(pattern)`` of group ``l // len(pattern)``. Every mixer
of the reference is ported (attention, mamba, mLSTM, sLSTM), with dense
(SwiGLU), MoE or no FF, RoPE, sinusoidal or no positions and tied or
separate embeddings; ``encoder_layers > 0`` adds whisper's encoder and a
cross-attention in every decoder attention block, ``frontend="vision"``
internvl2's projected patch embeddings in front of the tokens.
``attn_impl="chunked"`` makes the train and prefill forwards (and the
unfused decode read) attend by an online softmax over ``attn_chunk``-long
KV chunks; that keeps only one chunk's scores alive in prefill and other
no-grad calls, while a training backward keeps every chunk's (autograd
saves them). ``opt_bwd_cast`` is kept for parity with the reference's
configs and changes nothing here. ``remat``: the train forward
recomputes each block in the backward (``torch.utils.checkpoint``) as the
reference rematerializes its scan body.

The distribution knobs are the reference's: ``fsdp`` shards the
parameters' reduction dim over the data axes too (``models.sharding``'s
rules, read by ``launch.shardings.rules_for``); ``opt_head_shard`` runs
attention over KV broadcast to every query head (``attention._mha_*``)
with the head axis pinned to the model axis; ``opt_seq_par`` pins the
residual stream to ``seq_sp`` between blocks (``model.Block``). The pins
are ``models.sharding.constrain`` calls: they act on DTensor activations
and leave plain tensors as they are. Under the sharded train step's
model axis (``models.parallel.model_axis``) ``opt_seq_par`` runs the residual
stream and the norms on each model rank's chunk of the sequence.
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

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0                # >0 => enc-dec
    encoder_seq: int = 1500                # audio frames after conv stub

    # --- modality frontend stubs ---
    frontend: Literal["none", "audio", "vision"] = "none"
    vision_tokens: int = 256               # patch embeds prepended (vlm stub)

    pos: Literal["rope", "sinusoidal", "none"] = "rope"
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # which attention implementation train/prefill uses
    attn_impl: Literal["naive", "chunked"] = "naive"
    attn_chunk: int = 2048
    # decode attends the packed KV cache with the fused kernel instead of
    # dequantizing the whole cache each step (engages for packed caches)
    fused_attention: bool = False

    # --- distribution knobs ---
    fsdp: bool = False                     # shard params over "data" too
    remat: bool = True                     # recompute each block in backward

    # the reference's logits-cotangent cast; inert here, as the loss's
    # input cast already hands the cotangent back in the model dtype
    opt_bwd_cast: bool = False
    # broadcast KV to every query head and pin the head axis to "model"
    opt_head_shard: bool = False
    # sequence parallelism: the residual stream pinned to "seq_sp"
    opt_seq_par: bool = False

    def __post_init__(self):
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
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

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
        if self.is_encdec:
            # encoder self-attn + dense ff + cross-attn params in decoder
            # blocks (the reference leaves out norm_cross and vision_proj)
            total += self.encoder_layers * (per["attn"] + ff["dense"] + 2 * D)
            total += self.n_layers * per["attn"]  # cross attention
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
