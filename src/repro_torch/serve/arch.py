"""Architecture registry for the batched serve engine (port of
``repro.serve.arch``).

``SupportedArchitecture`` records what the continuous-batching engine must
not hardcode: its capability flags (paged KV, recurrent per-slot state,
exact co-batching, a prefill bucket override), the page size and the step
factories. ``register_architecture`` adds or replaces a family's entry;
``arch_for(cfg)`` picks the family from the pattern and resolves the flags
against it. The reference's four families are registered with its flags:
``llama-dense``, ``moe``, ``ssm-hybrid`` (mamba with attention: recurrent
state, exact-length prefill) and ``xlstm`` (recurrent state, no paged
KV).

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
from repro_torch.models.config import ModelConfig

__all__ = ["SupportedArchitecture", "arch_for", "make_batched_prefill",
           "make_batched_decode_step", "register_architecture",
           "sample_tokens"]

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
    # capability flags
    paged_kv: bool            # has attention KV worth paging
    recurrent_state: bool     # mamba/xLSTM per-slot state rides along
    exact_cobatch: bool       # batched greedy decode == sequential, bitwise
    # policy defaults
    page_tokens: int = 8
    # () = exact-length prefill (recurrent scans consume every token, so
    # bucket padding would pollute the state); None = engine default buckets
    prefill_buckets: tuple[int, ...] | None = None
    # step factories (cfg -> callables)
    prefill_factory: Callable = make_batched_prefill
    step_factory: Callable = make_batched_decode_step


_REGISTRY: dict[str, SupportedArchitecture] = {}


def register_architecture(arch: SupportedArchitecture) -> None:
    _REGISTRY[arch.name] = arch


for _arch in (
    SupportedArchitecture(name="llama-dense", paged_kv=True,
                          recurrent_state=False, exact_cobatch=True),
    SupportedArchitecture(name="moe", paged_kv=True, recurrent_state=False,
                          # capacity-factor token dropping couples
                          # co-scheduled tokens: batched != sequential
                          exact_cobatch=False),
    SupportedArchitecture(name="ssm-hybrid", paged_kv=True,
                          recurrent_state=True, exact_cobatch=True,
                          prefill_buckets=()),
    SupportedArchitecture(name="xlstm", paged_kv=False, recurrent_state=True,
                          exact_cobatch=True, prefill_buckets=()),
):
    register_architecture(_arch)


def _family(cfg: ModelConfig) -> str:
    mixers = {s.mixer for s in cfg.pattern}
    if "mamba" in mixers:
        return "ssm-hybrid"
    if "mlstm" in mixers or "slstm" in mixers:
        return "xlstm"
    if any(s.ff == "moe" for s in cfg.pattern):
        return "moe"
    return "llama-dense"


def arch_for(cfg: ModelConfig) -> SupportedArchitecture:
    """The registry entry for ``cfg``'s family, resolved against the
    concrete pattern (a pattern with MoE FFs loses exact_cobatch; an entry
    never claims paged KV for a pattern without attention)."""
    base = _REGISTRY[_family(cfg)]
    has_attn = any(s.mixer == "attn" for s in cfg.pattern)
    has_moe = any(s.ff == "moe" for s in cfg.pattern)
    return dataclasses.replace(
        base,
        paged_kv=base.paged_kv and has_attn,
        exact_cobatch=base.exact_cobatch and not has_moe)
