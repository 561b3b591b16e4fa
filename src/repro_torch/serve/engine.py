"""Sequential serving engine (port of ``repro.serve.engine``: ``ServeConfig``
and ``Engine.generate`` with the periodic EOS sync).

One fixed-shape request batch runs start to finish: prefill the prompts,
then decode until ``max_new`` or EOS. Tokens stay on the device and reach
the host once at the end; with EOS on, the all-done flag is read only every
``eos_sync_every`` steps. The reference donates the cache buffers to its
jitted steps; here the caches are written in place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import decode_step, init_caches, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.serve.arch import sample_tokens


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int
    max_seq: int
    quantized_kv: bool = False
    temperature: float = 0.0   # 0 = greedy
    seed: int = 0              # sampling stream root
    # decode attends the packed KV with the fused kernel (else the whole
    # cache is dequantized each step and attended by naive attention)
    fused_attention: bool = False
    eos_sync_every: int = 8    # EOS mode: steps between host syncs


class Engine:
    """Batched engine: prefill a batch of prompts, then decode until
    max_new or EOS. ``model`` is a :class:`~repro_torch.models.Model`; the
    engine runs on the model's device."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, model: Model):
        if scfg.fused_attention and not cfg.fused_attention:
            cfg = dataclasses.replace(cfg, fused_attention=True)
        self.cfg, self.scfg, self.model = cfg, scfg, model
        self.device = model.device

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new: int, eos: int = -1,
                 request_ids=None) -> np.ndarray:
        """Greedy (or sampled) decode of ``prompts [B, S]``; returns
        ``[B, <= max_new]`` int tokens. Partial batches pad to the
        configured batch and slice off; ``request_ids [B]`` key the
        per-request sample streams (default: row index)."""
        B, S = prompts.shape
        Bc = self.scfg.batch
        if B > Bc:
            raise ValueError(f"batch {B} exceeds configured {Bc}")
        if B < Bc:
            prompts = np.concatenate(
                [prompts, np.zeros((Bc - B, S), prompts.dtype)], axis=0)
        rids = np.arange(B) if request_ids is None else np.asarray(request_ids)
        if rids.shape != (B,):
            raise ValueError(f"request_ids must be [{B}], got {rids.shape}")
        rids = torch.as_tensor(np.concatenate([rids, np.zeros(Bc - B, int)]),
                               device=self.device)
        caches = init_caches(self.cfg, Bc, self.scfg.max_seq,
                             quantized_kv=self.scfg.quantized_kv,
                             device=self.device)
        model, cfg = self.model, self.cfg
        tokens = torch.as_tensor(prompts, device=self.device).to(torch.int64)
        logits = prefill(model, tokens, caches, cfg=cfg)
        tok = torch.argmax(logits, -1)[:, None]
        out = [tok]
        sync_k = max(1, self.scfg.eos_sync_every)
        done = None
        if eos >= 0:      # padded rows start done
            done = (tok[:, 0] == eos) | (torch.arange(Bc, device=self.device)
                                         >= B)
        for i in range(max_new - 1):
            pos = S + i
            logits = decode_step(model, tok, pos, caches, cfg=cfg)
            if self.scfg.temperature > 0:
                nxt = sample_tokens(logits, rids, pos, seed=self.scfg.seed,
                                    temperature=self.scfg.temperature)
            else:
                nxt = torch.argmax(logits, -1)
            tok = nxt[:, None]
            out.append(tok)
            if eos >= 0:
                done = done | (tok[:, 0] == eos)   # stays on device
                if (i + 1) % sync_k == 0 and bool(done.all()):
                    break
        return torch.cat(out, dim=1).cpu().numpy()[:B]
