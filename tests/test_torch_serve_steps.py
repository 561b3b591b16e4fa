"""Port parity, the serve step factories: ``repro_torch.serve``'s
``make_prefill_step`` / ``make_serve_step`` against ``repro.serve``'s, on
the smoke llama3.2-3b (f32) with the reference's weights carried over by
``params_from_jax``.

Tolerances and why (those of ``tests/test_torch_model.py``):
- prefill and decode logits within rtol=atol=1e-4: torch and XLA sum the
  f32 matmuls in other orders, and a one-ulp difference in k can land on
  the other side of an F2P rounding boundary and move one KV code a step;
- greedy tokens over 8 steps EQUAL;
- the ``fused_attention`` override: the reference turns the fused decode
  on for a config that has it off and never turns it off; the port's steps
  do the same, so each step's token is the argmax of a ``decode_step``
  under the overridden config, and the tokens equal the reference's;
- sampled tokens (``temperature > 0``) EQUAL ``sample_tokens`` on the
  step's logits (the port's Gumbel-max, C14: not ``jax.random``'s bits),
  and a request's draw does not depend on which rows share its batch.
"""
import copy
import dataclasses

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.serve import ServeConfig as JServeConfig
from repro.serve import make_prefill_step as jmake_prefill_step
from repro.serve import make_serve_step as jmake_serve_step
from repro_torch.configs import smoke_config
from repro_torch.models import decode_step, init_caches
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import (Engine, ServeConfig, make_prefill_step,
                               make_serve_step, sample_tokens)
from repro_torch.serve.engine import _serve_model_cfg

CPU = torch.device("cpu")
B, S, MAX_SEQ, STEPS = 2, 7, 32, 8


@pytest.fixture(scope="module")
def both():
    jcfg = jsmoke("llama3_2_3b")
    cfg = smoke_config("llama3_2_3b")
    assert not cfg.fused_attention and not jcfg.fused_attention
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    return jcfg, jparams, cfg, model, toks.astype(np.int32)


def _reference_run(jcfg, jparams, toks, scfg_kw):
    """The reference's two steps: last-token logits per step and tokens."""
    jscfg = JServeConfig(batch=B, max_seq=MAX_SEQ, **scfg_kw)
    prefill_step = jax.jit(jmake_prefill_step(jcfg, jscfg))
    serve_step = jax.jit(jmake_serve_step(jcfg, jscfg))
    jc = jinit_caches(jcfg, B, MAX_SEQ, quantized_kv=jscfg.quantized_kv,
                      packed_kv=True)
    logits, jc = prefill_step(jparams, {"tokens": jnp.asarray(toks)}, jc)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks_out, logs = [np.asarray(tok)], [np.asarray(logits)]
    for i in range(STEPS):
        tok, jc = serve_step(jparams, jc, tok, jnp.int32(S + i))
        toks_out.append(np.asarray(tok))
    return logs, np.concatenate(toks_out, 1)


@pytest.mark.parametrize("quantized_kv", [False, True])
def test_prefill_logits_and_greedy_tokens_match_jax(both, quantized_kv):
    jcfg, jparams, cfg, model, toks = both
    kw = dict(quantized_kv=quantized_kv, fused_attention=quantized_kv)
    jlogs, jtoks = _reference_run(jcfg, jparams, toks, kw)
    scfg = ServeConfig(batch=B, max_seq=MAX_SEQ, **kw)
    prefill_step = make_prefill_step(cfg, scfg)
    serve_step = make_serve_step(cfg, scfg)
    caches = init_caches(cfg, B, MAX_SEQ, quantized_kv=quantized_kv,
                         device=CPU)
    logits, out = prefill_step(model, {"tokens": toks}, caches)
    assert out is caches                   # written in place, handed back
    np.testing.assert_allclose(logits.numpy(), jlogs[0], rtol=1e-4,
                               atol=1e-4)
    tok = torch.argmax(logits, -1)[:, None]
    got = [tok]
    for i in range(STEPS):
        tok, out = serve_step(model, caches, tok, S + i)
        assert out is caches and tok.shape == (B, 1)
        got.append(tok)
    np.testing.assert_array_equal(torch.cat(got, 1).numpy(), jtoks)


def test_fused_attention_override_acts_as_in_the_reference(both):
    jcfg, jparams, cfg, model, toks = both
    kw = dict(quantized_kv=True, fused_attention=True)
    scfg = ServeConfig(batch=B, max_seq=MAX_SEQ, **kw)
    # the override only turns the fused decode on, in both packages
    assert _serve_model_cfg(cfg, scfg).fused_attention
    fused_cfg = dataclasses.replace(cfg, fused_attention=True)
    off = ServeConfig(batch=B, max_seq=MAX_SEQ, quantized_kv=True)
    assert _serve_model_cfg(fused_cfg, off) is fused_cfg
    assert Engine(cfg, scfg, model).cfg.fused_attention
    assert not Engine(cfg, off, model).cfg.fused_attention

    caches = init_caches(cfg, B, MAX_SEQ, quantized_kv=True, device=CPU)
    ref_caches = init_caches(cfg, B, MAX_SEQ, quantized_kv=True, device=CPU)
    logits, _ = make_prefill_step(cfg, scfg)(model, {"tokens": toks}, caches)
    make_prefill_step(fused_cfg, off)(model, {"tokens": toks}, ref_caches)
    tok = torch.argmax(logits, -1)[:, None]
    serve_step = make_serve_step(cfg, scfg)
    for i in range(3):
        want = decode_step(model, tok, S + i, ref_caches, cfg=fused_cfg)
        nxt, _ = serve_step(model, caches, tok, S + i)
        assert torch.equal(nxt[:, 0], torch.argmax(want, -1))
        tok = nxt
    _, jtoks = _reference_run(jcfg, jparams, toks, kw)
    _, ptoks = _port_tokens(cfg, model, toks, scfg)
    np.testing.assert_array_equal(ptoks, jtoks)


def _port_tokens(cfg, model, toks, scfg, req_ids=None):
    caches = init_caches(cfg, toks.shape[0], MAX_SEQ,
                         quantized_kv=scfg.quantized_kv, device=CPU)
    logits, _ = make_prefill_step(cfg, scfg)(model, {"tokens": toks}, caches)
    tok = torch.argmax(logits, -1)[:, None]
    out, logs = [tok], []
    step = make_serve_step(cfg, scfg)
    for i in range(STEPS):
        # the logits the step samples from (a copy of the caches keeps the
        # step's own state untouched)
        logs.append(decode_step(model, tok, S + i, copy.deepcopy(caches),
                                cfg=_serve_model_cfg(cfg, scfg)))
        tok, _ = step(model, caches, tok, S + i, req_ids)
        out.append(tok)
    return logs, torch.cat(out, 1).numpy()


def test_sampled_tokens_are_sample_tokens_and_batch_independent(both):
    _, _, cfg, model, toks = both
    scfg = ServeConfig(batch=3, max_seq=MAX_SEQ, quantized_kv=True,
                       fused_attention=True, temperature=0.8, seed=5)
    # three rows with one prompt: the same logits, so the draws differ only
    # by request id
    same = np.repeat(toks[:1], 3, axis=0)
    rids = torch.tensor([11, 22, 33])
    logs, got = _port_tokens(cfg, model, same, scfg, rids)
    for i, lg in enumerate(logs):
        want = sample_tokens(lg, rids, S + i, seed=5, temperature=0.8)
        assert torch.equal(torch.as_tensor(got[:, i + 1]), want), i
    # a permuted batch permutes the rows' tokens with their requests
    perm = [2, 0, 1]
    _, got_p = _port_tokens(cfg, model, same, scfg, rids[perm])
    np.testing.assert_array_equal(got_p, got[perm])
    # one request alone draws what it drew in company
    _, alone = _port_tokens(cfg, model, same[:1],
                            dataclasses.replace(scfg, batch=1), rids[1:2])
    np.testing.assert_array_equal(alone[0], got[1])
    # req_ids default to the row index
    _, dflt = _port_tokens(cfg, model, same, scfg)
    _, idx = _port_tokens(cfg, model, same, scfg, torch.arange(3))
    np.testing.assert_array_equal(dflt, idx)
    # the draws differ between requests (the step really samples)
    assert not (got[0, 1:] == got[1, 1:]).all()


def test_engine_generate_is_the_two_steps(both):
    """``Engine`` runs on the factories: its tokens are theirs."""
    _, _, cfg, model, toks = both
    scfg = ServeConfig(batch=B, max_seq=MAX_SEQ, quantized_kv=True,
                       fused_attention=True)
    _, want = _port_tokens(cfg, model, toks, scfg)
    got = Engine(cfg, scfg, model).generate(toks, STEPS + 1)
    np.testing.assert_array_equal(got, want)
