"""Deterministic, resumable, shard-aware synthetic data pipeline (a copy of
``repro.data.pipeline``, numpy only: both packages train on the same
batches).

Production properties this models faithfully:
  * step-indexed determinism: batch(step) is a pure function of (seed, step),
    so preempted jobs resume mid-epoch with no state file beyond the step
    counter in the checkpoint;
  * host-sharded loading: each process materializes only its slice of the
    global batch (by process_index), matching multi-host array creation;
  * mixture streams: zipfian token stream + repeated n-gram structure so a
    ~100M model's loss actually drops (quickstart trains against this).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    ngram_period: int = 16


def _batch_np(cfg: DataConfig, step: int, start: int, count: int):
    """Rows [start, start+count) of the global batch at `step` (host numpy).
    Each row is seeded by its GLOBAL row index, so any host's slice tiles the
    global batch exactly regardless of process layout (elastic-safe)."""
    pattern = (np.arange(cfg.seq_len + 1) % cfg.ngram_period) * 7 % cfg.vocab_size
    rows = []
    for r in range(start, start + count):
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, r]))
        z = np.minimum(rng.zipf(cfg.zipf_a, size=cfg.seq_len + 1),
                       cfg.vocab_size - 1)
        mask = rng.random(cfg.seq_len + 1) < 0.5
        rows.append(np.where(mask, pattern, z))
    return np.stack(rows).astype(np.int32)


def host_batch(cfg: DataConfig, step: int, *, process_index: int = 0,
               process_count: int = 1):
    """This host's rows of the global batch: tokens/labels [B_host, S]."""
    per = cfg.global_batch // process_count
    toks = _batch_np(cfg, step, process_index * per, per)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def global_batch(cfg: DataConfig, step: int):
    b = _batch_np(cfg, step, 0, cfg.global_batch)
    return {"tokens": b[:, :-1], "labels": b[:, 1:].copy()}
