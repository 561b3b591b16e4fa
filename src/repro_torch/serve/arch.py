"""Architecture registry for the batched serve engine (port of
``repro.serve.arch``), llama-dense only.

``SupportedArchitecture`` records what the continuous-batching engine must
not hardcode: the page size and the step factories. (The reference's
capability flags — paged KV, recurrent state, exact co-batching, prefill
bucket override — are constant for the one ported family: paged, none,
yes, engine default.) ``arch_for(cfg)`` returns the llama-dense entry;
every other family raises ``NotImplementedError`` (ROADMAP A13).

Temperature sampling is Gumbel-max over uniforms drawn from a counter-based
hash (``fmix32``) of ``(seed, request uid, position, vocab index)``: a
request's draws are a pure function of the request, whichever requests
share its batch and whichever slot it lands in (the property the
reference's ``fold_in`` keys give; the bits differ from JAX's).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels.bits import fmix32
from repro_torch.models import decode_step, prefill
from repro_torch.models.config import BlockSpec, ModelConfig

__all__ = ["SupportedArchitecture", "arch_for", "make_batched_prefill",
           "make_batched_decode_step", "sample_tokens"]

_GOLDEN = 0x9E3779B9


def sample_tokens(logits: torch.Tensor, req, pos, *, seed: int,
                  temperature: float) -> torch.Tensor:
    """Gumbel-max draw per row of ``logits [B, V]``; ``req``/``pos`` are
    ``[B]`` request ids and positions. Uniforms are
    ``(fmix32(key_b ^ fmix32(v)) >> 8 + 0.5) / 2^24`` with
    ``key_b = fmix32(fmix32(fmix32(seed) ^ req_b) ^ pos_b)``."""
    B, V = logits.shape
    dev = logits.device
    req = torch.as_tensor(req, device=dev).to(torch.int64).expand(B)
    pos = torch.as_tensor(pos, device=dev).to(torch.int64).expand(B)
    seed_h = fmix32(torch.full((), int(seed) & 0xFFFFFFFF, device=dev,
                               dtype=torch.int64))
    key = fmix32(fmix32(seed_h ^ (req & 0xFFFFFFFF)) ^ (pos & 0xFFFFFFFF))
    lane = fmix32(torch.arange(V, device=dev, dtype=torch.int64) * _GOLDEN)
    bits = fmix32(key[:, None] ^ lane[None, :])
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.to(torch.float32) / temperature + gumbel, -1)


def make_batched_prefill(cfg: ModelConfig):
    """prefill_step(model, tokens [N, S], caches, last_index [N]) -> logits."""

    def prefill_step(model, tokens, caches, last_index):
        return prefill(model, tokens, caches, last_index=last_index, cfg=cfg)

    return prefill_step


def make_batched_decode_step(cfg: ModelConfig, *, temperature: float,
                             seed: int, max_seq: int):
    """step(model, caches, tok [B,1], pos [B], req [B], pages)
        -> (next_tok [B,1] int64, next_pos [B])

    Caches (or the pool slabs, with ``pages``) are updated in place. Retired
    slots keep stepping at a clamped dead position until a new request
    joins; their writes land where they are never read."""

    def step(model, caches, tok, pos, req, pages=None):
        logits = decode_step(model, tok, pos, caches, pages=pages, cfg=cfg)
        if temperature > 0:
            nxt = sample_tokens(logits, req, pos, seed=seed,
                                temperature=temperature)
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt[:, None], torch.clamp(pos + 1, max=max_seq - 1)

    return step


@dataclasses.dataclass(frozen=True)
class SupportedArchitecture:
    """Per-family serving contract + policy defaults."""
    name: str
    page_tokens: int = 8
    prefill_factory: Callable = make_batched_prefill
    step_factory: Callable = make_batched_decode_step


LLAMA_DENSE = SupportedArchitecture(name="llama-dense")


def arch_for(cfg: ModelConfig) -> SupportedArchitecture:
    """The registry entry for ``cfg``'s family: llama-dense only."""
    if any(s != BlockSpec("attn", "dense") for s in cfg.pattern):
        raise NotImplementedError(
            "only the llama-dense family is ported; moe, ssm-hybrid and "
            "xlstm serving are ROADMAP A13")
    return LLAMA_DENSE
