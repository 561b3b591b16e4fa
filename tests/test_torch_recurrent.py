"""Port parity, the recurrent families as a whole: the mamba hybrid
(jamba) and xLSTM against the JAX reference at smoke size (f32, the
reference's weights carried over by ``params_from_jax``, inputs drawn with
numpy from a seed).

* Registry and configs: both full and smoke configs' analytic parameter
  counts equal the reference's exactly, the default policies equal its
  (jamba's ``grad/*ff*`` at block 256) and ``arch_for`` gives its family
  flags.
* Models: prefill and 6 decode steps' logits within 1e-4, greedy tokens
  equal; ``train_forward``'s loss within 1e-5 and every gradient within
  rtol = 1e-4 (atol 1e-4 x the leaf's largest gradient); jamba's paged
  decode equals its dense decode bitwise; the recurrent state after a
  prefill equals the reference's (``recurrent_caches_from_jax``, 1e-5).
* Engines: xLSTM's ``BatchedEngine`` gives the sequential ``Engine``'s
  tokens and both give the reference ``Engine``'s; jamba's port engine
  gives the reference ``BatchedEngine``'s tokens mode for mode (both
  ``io_upload="full"``, ROADMAP C-ref4); a preempted, host-evicted and
  readmitted request gives its uninterrupted tokens; two different
  prompts of one length admitted one after the other each get the
  tokens they get alone (a fresh zero state per admission).
* Training: the CLI defaults to ``xlstm_125m``; three ``run()`` steps on
  smoke xLSTM from the reference's initial state (its checkpoint) give the
  reference train step's losses within 1e-4; xLSTM's compressed leaves
  are the reference's, and its checkpoint files are byte-identical.
"""
import dataclasses
import os

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import default_policy as jdefault_policy
from repro.configs import full_config as jfull_config
from repro.configs import smoke_config as jax_smoke
from repro.data import DataConfig as JDataConfig
from repro.data import host_batch as jhost_batch
from repro.models import decode_step as jdecode
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models import train_forward as jtrain_forward
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import CompressionConfig as JCompressionConfig
from repro.serve import BatchedEngine as JBatched
from repro.serve import BatchedServeConfig as JBatchedConfig
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import arch_for as jarch_for
from repro.train import checkpoint as jckpt
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import default_policy, full_config, smoke_config
from repro_torch.launch import train as launch_train
from repro_torch.models import (decode_step, init_caches, init_params,
                                prefill, train_forward)
from repro_torch.models.convert import (params_from_jax,
                                        recurrent_caches_from_jax,
                                        reference_layout, reference_numel,
                                        reference_path, train_state_from_jax)
from repro_torch.optim import (CompressionConfig, compress_decompress,
                               init_residuals)
from repro_torch.optim.compress import compressed_leaves
from repro_torch.serve import (BatchedEngine, BatchedServeConfig, Engine,
                               Request, ServeConfig, arch_for)
from repro_torch.train import checkpoint, init_train_state

CPU = torch.device("cpu")
ARCHS = ["jamba_1_5_large", "xlstm_125m"]
JAMBA, XLSTM = ARCHS


def _pair(arch, **over):
    jcfg = dataclasses.replace(jax_smoke(arch), **over)
    cfg = dataclasses.replace(smoke_config(arch), **over)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module")
def pairs():
    return {a: _pair(a) for a in ARCHS}


# ---------------------------------------------------------------------------
# registry and configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_policy_equal_reference(arch):
    assert full_config(arch).param_count() == \
        jfull_config(arch).param_count()
    assert smoke_config(arch).param_count() == jax_smoke(arch).param_count()
    assert default_policy(arch).to_dict() == jdefault_policy(arch).to_dict()
    cfg = full_config(arch)
    assert cfg.is_subquadratic and cfg.d_inner == 2 * cfg.d_model


def test_jamba_policy_and_the_one_group_cut():
    rule = default_policy(JAMBA).rules[0]
    assert (rule.pattern, rule.block) == ("grad/*ff*", 256)
    cut = dataclasses.replace(full_config(JAMBA), n_layers=8, n_experts=8)
    jcut = dataclasses.replace(jfull_config(JAMBA), n_layers=8, n_experts=8)
    assert cut.param_count() == jcut.param_count() == 25_793_167_360


@pytest.mark.parametrize("arch,want", [
    (JAMBA, ("ssm-hybrid", True, True, False, ())),
    (XLSTM, ("xlstm", False, True, True, ()))])
def test_arch_for_flags_match_reference(arch, want):
    a, j = arch_for(smoke_config(arch)), jarch_for(jax_smoke(arch))
    got = (a.name, a.paged_kv, a.recurrent_state, a.exact_cobatch,
           a.prefill_buckets)
    assert got == want == (j.name, j.paged_kv, j.recurrent_state,
                           j.exact_cobatch, j.prefill_buckets)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_logits_and_tokens_match_jax(pairs, arch):
    jcfg, jparams, cfg, model = pairs[arch]
    B, S0 = 3, 12
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S0))
    jc = jinit_caches(jcfg, B, 32, quantized_kv=True, packed_kv=True)
    tc = init_caches(cfg, B, 32, quantized_kv=True, device=CPU)
    jl, jc = jax.jit(jprefill, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(toks)}, jcfg, jc)
    tl = prefill(model, torch.from_numpy(toks), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    # the recurrent state the prefill left, against the reference's
    want = recurrent_caches_from_jax(jax.tree.map(np.asarray, jc), cfg, CPU)
    for key, leaves in want.items():
        for name, w in leaves.items():
            np.testing.assert_allclose(tc[key][name].numpy(), w.numpy(),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{key}/{name}")
    step = jax.jit(jdecode, static_argnums=4)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None]
    for i in range(6):
        jl, jc = step(jparams, jnp.asarray(tok), S0 + i, jc, jcfg)
        tl = decode_step(model, torch.from_numpy(tok.copy()), S0 + i, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        want = np.asarray(jnp.argmax(jl, -1))
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), want)
        tok = want[:, None]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_loss_and_grads_match_jax(pairs, arch):
    jcfg, jparams, cfg, model = pairs[arch]
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jtot, _), jg = jax.value_and_grad(
        lambda p: jtrain_forward(p, jb, jcfg), has_aux=True)(jparams)
    model.requires_grad_(True)
    try:
        model.zero_grad(set_to_none=True)
        tot, _ = train_forward(model, {"tokens": torch.from_numpy(toks),
                                       "labels": torch.from_numpy(labels)},
                               cfg)
        tot.backward()
        np.testing.assert_allclose(float(tot.detach()), float(jtot),
                                   rtol=1e-5, atol=1e-5)
        jg = jax.tree.map(np.asarray, jg)
        P = len(cfg.pattern)
        assert (model.lm_head is None) == cfg.tie_embeddings
        for name, p in model.named_parameters():
            path, layer = reference_path(name, P)
            w = jg
            for k in path:
                w = w[k]
            w = w if layer is None else w[layer]
            np.testing.assert_allclose(
                p.grad.numpy(), w, rtol=1e-4,
                atol=1e-4 * float(np.abs(w).max()) + 1e-9, err_msg=name)
    finally:
        model.requires_grad_(False)
        model.zero_grad(set_to_none=True)


def test_jamba_paged_decode_equals_dense_bitwise(pairs):
    """One prefill's KV copied into pool slabs at permuted pages (the
    recurrent state shared): paged and dense decode give the same logits,
    bitwise, over 3 steps."""
    _, _, cfg, model = pairs[JAMBA]
    cfg = dataclasses.replace(cfg, fused_attention=True)
    B, T, maxp = 3, 8, 4
    P = B * maxp + 2
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 11))
    tc = init_caches(cfg, B, maxp * T, quantized_kv=True, device=CPU)
    prefill(model, torch.from_numpy(toks), tc, cfg=cfg)
    slabs = init_caches(cfg, 1, P * T, quantized_kv=True, device=CPU)
    perm = torch.from_numpy(np.random.default_rng(3).permutation(P))
    pages = perm[:B * maxp].reshape(B, maxp).to(torch.int32)
    G, K = cfg.n_groups, cfg.n_kv_heads
    paged = {k: {n: t.clone() for n, t in v.items()} for k, v in tc.items()
             if k != "b4"}
    for kv in ("k", "v"):
        src, dst = tc["b4"][kv], slabs["b4"][kv]
        W = src.codes.shape[-1]
        codes = dst.codes.view(torch.int32).reshape(G, P, T, K, W)
        scales = dst.scales.reshape(G, P, T, K, 1)
        codes[:, pages.flatten().long()] = src.codes.view(
            torch.int32).reshape(G, B * maxp, T, K, W)
        scales[:, pages.flatten().long()] = src.scales.reshape(
            G, B * maxp, T, K, 1)
        slabs["b4"][kv] = type(dst)(codes.view(torch.uint32), scales,
                                    dst.fmt, dst.block,
                                    (G, P, T, K, cfg.head_dim), packed=True)
    paged["b4"] = slabs["b4"]
    tok = torch.tensor([[5], [7], [9]])
    pos = torch.tensor([11, 11, 11])
    for _ in range(3):
        dense = decode_step(model, tok, pos, tc, cfg=cfg)
        pg = decode_step(model, tok, pos, paged, pages=pages, cfg=cfg)
        assert torch.equal(dense, pg)
        tok = torch.argmax(dense, -1)[:, None]
        pos = pos + 1


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------
def _spec(cfg, n, seed=0, stagger=3, lo=4, hi=20, max_new=(3, 12)):
    rng = np.random.default_rng(seed)
    return [(u + 1, rng.integers(0, cfg.vocab_size,
                                 int(rng.integers(lo, hi))).astype(np.int32),
             int(rng.integers(*max_new)), stagger * u) for u in range(n)]


def _reqs(spec):
    return [Request(uid=u, tokens=t, max_new=m, arrival=a)
            for u, t, m, a in spec]


def _port_sequential(cfg, model, spec, max_seq=64):
    eng = Engine(cfg, ServeConfig(batch=1, max_seq=max_seq,
                                  quantized_kv=True, fused_attention=True),
                 model)
    return {u: eng.generate(t[None], m)[0] for u, t, m, _ in spec}


def test_xlstm_batched_equals_sequential_and_reference(pairs):
    jcfg, jparams, cfg, model = pairs[XLSTM]
    spec = _spec(cfg, 5)
    eng = BatchedEngine(cfg, BatchedServeConfig(slots=3, max_seq=64), model)
    assert eng.pool is None and eng.pages is None
    out = eng.run(_reqs(spec))
    seq = _port_sequential(cfg, model, spec)
    jeng = JEngine(jcfg, JServeConfig(batch=1, max_seq=64), jparams)
    for u, t, m, _ in spec:
        np.testing.assert_array_equal(out[u], seq[u].astype(np.int32))
        np.testing.assert_array_equal(
            seq[u], np.asarray(jeng.generate(t[None], m)[0]))
    assert eng.stats["prefill_calls"] == eng.stats["prefills"] == len(spec)
    assert "pool" not in eng.stats
    # 3 mLSTM layers of (C, n, m) and one sLSTM of 4 x [D], f32
    H, D = cfg.n_heads, cfg.d_model
    hd = cfg.mlstm_expand * D // H
    assert eng.state_bytes_per_slot() == 4 * (
        3 * (H * hd * hd + H * hd + H) + 4 * D)


@pytest.mark.parametrize("paged", [True, False])
def test_jamba_batched_matches_reference_engine(pairs, paged):
    """Mode for mode against the reference's BatchedEngine (FIFO, whole
    uploads): jamba's MoE FFs make tokens depend on the co-scheduled set."""
    jcfg, jparams, cfg, model = pairs[JAMBA]
    spec = _spec(cfg, 5, seed=1)
    kw = dict(slots=3, max_seq=64, paged_decode=paged, scheduler="fifo",
              io_upload="full")
    want = JBatched(jcfg, JBatchedConfig(**kw), jparams).run(
        [JRequest(uid=u, tokens=t, max_new=m, arrival=a)
         for u, t, m, a in spec])
    eng = BatchedEngine(cfg, BatchedServeConfig(**kw), model)
    got = eng.run(_reqs(spec))
    assert sorted(want) == sorted(got)
    for u in want:
        np.testing.assert_array_equal(got[u], np.asarray(want[u]),
                                      err_msg=f"paged={paged}: request {u}")
    assert eng.stats["prefill_calls"] == len(spec)
    assert eng.stats["pool"]["used"] == (1 if paged else 0)


@pytest.mark.parametrize("arch,paged", [(XLSTM, None), (JAMBA, True),
                                        (JAMBA, False)])
def test_preempt_evict_readmit_keeps_tokens(pairs, arch, paged):
    """Starvation preempts the longest-tail slot: its recurrent rows (and
    KV) go to the host and come back on readmission; the tokens equal an
    uninterrupted run (sequential for xLSTM; for jamba, whose MoE
    co-batching decides tokens, the same workload with preemption off)."""
    _, _, cfg, model = pairs[arch]
    spec = _spec(cfg, 5, seed=7, stagger=0, lo=3, hi=13, max_new=(16, 17))
    kw = dict(slots=2, max_seq=32, sync_every=4)
    if paged is not None:
        kw["paged_decode"] = paged
    eng = BatchedEngine(cfg, BatchedServeConfig(preempt_patience=1,
                                                scheduler="fifo", **kw),
                        model)
    out = eng.run(_reqs(spec))
    assert eng.stats.get("preemptions", 0) > 0
    assert eng.stats.get("readmits", 0) > 0
    if arch == XLSTM:
        want = _port_sequential(cfg, model, spec, 32)
    else:
        assert eng.stats.get("host_evictions", 0) > 0
        # the reference's engine under the same preemptions
        jcfg, jparams = pairs[arch][:2]
        want = JBatched(jcfg, JBatchedConfig(
            preempt_patience=1, scheduler="fifo", io_upload="full", **kw),
            jparams).run([JRequest(uid=u, tokens=t, max_new=m, arrival=a)
                          for u, t, m, a in spec])
    for u, _, _, _ in spec:
        np.testing.assert_array_equal(out[u], np.asarray(want[u]).astype(
            np.int32), err_msg=f"request {u}")


def test_preempt_hook_round_trips_the_state_bitwise(pairs):
    """``preempt(uid)`` parks a live xLSTM slot: its host rows are the
    slot's rows bitwise, ``[G, 1, ...]``, and readmission writes them back
    into whichever slot is free."""
    _, _, cfg, model = pairs[XLSTM]
    eng = BatchedEngine(cfg, BatchedServeConfig(slots=2, max_seq=32), model)
    spec = _spec(cfg, 2, seed=3, stagger=0)
    results = {}
    eng._rt = {u: {"visible": 0} for u, _, _, _ in spec}
    eng._admit_batch(list(zip(_reqs(spec), [0, 1])), results)
    eng._rounds()
    rows = {k: {n: leaf[:, 1].clone() for n, leaf in v.items()}
            for k, v in eng.caches.items()}
    parked = eng.preempt(spec[1][0])
    for k, v in parked.state.items():
        for n, host in v.items():
            assert host.device.type == "cpu"
            assert host.shape == (cfg.n_groups, 1) + rows[k][n].shape[1:]
            assert torch.equal(host[:, 0], rows[k][n])
    eng._readmit(eng._parked.popleft(), 0)
    for k, v in eng.caches.items():
        for n, leaf in v.items():
            assert torch.equal(leaf[:, 0], rows[k][n]), (k, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_admission_starts_from_a_zero_state(pairs, arch):
    """Two different prompts of one length, admitted one after the other
    into one slot: each request's tokens equal those it gets alone (a
    prefill cache reused across admissions would start the second from
    the first's final state)."""
    _, _, cfg, model = pairs[arch]
    rng = np.random.default_rng(11)
    a, b = (rng.integers(0, cfg.vocab_size, 9).astype(np.int32)
            for _ in range(2))
    assert not np.array_equal(a, b)
    bs = BatchedServeConfig(slots=1, max_seq=32)
    both = BatchedEngine(cfg, bs, model).run(
        [Request(uid=1, tokens=a, max_new=6),
         Request(uid=2, tokens=b, max_new=6, arrival=1)])
    for uid, t in ((1, a), (2, b)):
        alone = BatchedEngine(cfg, bs, model).run(
            [Request(uid=uid, tokens=t, max_new=6)])
        np.testing.assert_array_equal(both[uid], alone[uid])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def test_train_cli_defaults_to_xlstm():
    args = launch_train.parse_args([])
    assert args.arch == "xlstm_125m"
    assert "xlstm_125m" in (launch_train.__doc__ or "")


def _jax_train_setup(steps, gb, seq):
    """The reference launcher's configs for smoke xLSTM."""
    jcfg = jax_smoke(XLSTM)
    pol = jdefault_policy(XLSTM)
    gfmt, gblock = pol.f2p_for("grad", (JCompressionConfig.fmt, 128))
    jccfg = JCompressionConfig(enabled=True, min_size=512, fmt=gfmt,
                               block=gblock)
    jocfg = JAdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps)
    jdcfg = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=seq,
                        global_batch=gb)
    return jcfg, jocfg, jccfg, jdcfg


def test_run_three_steps_matches_reference(tmp_path):
    """launch.train.run from the reference's initial state (its checkpoint
    at step 0, which run() resumes from): three steps' losses equal the
    reference train step's on the same batches within 1e-4 relative."""
    steps, gb, seq = 3, 2, 16
    jcfg, jocfg, jccfg, jdcfg = _jax_train_setup(steps, gb, seq)
    st = jinit_train_state(jcfg, jocfg, jccfg, jax.random.PRNGKey(0))
    d = str(tmp_path / "run")
    jckpt.save(d, 0, st)
    jstep = jax.jit(jmake_train_step(jcfg, jocfg, jccfg))
    want = []
    for i in range(steps):
        st, m = jstep(st, {k: jnp.asarray(v)
                           for k, v in jhost_batch(jdcfg, i).items()})
        want.append(float(m["loss"]))
    logs = []
    _, info = launch_train.run(smoke_config(XLSTM), arch=XLSTM, steps=steps,
                               global_batch=gb, seq=seq, ckpt_dir=d,
                               device="cpu", log=logs.append)
    assert info["start"] == 0 and "resumed from step 0" in logs
    got = [h["loss"] for h in info["history"]]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert checkpoint.latest_step(d) == steps


def test_xlstm_compressed_leaves_and_checkpoint_match_reference(tmp_path):
    """The leaves min_size selects stack by the 4-position pattern, as the
    reference's; a train state's checkpoint files are byte-identical."""
    jcfg = jax_smoke(XLSTM)
    jst = jinit_train_state(jcfg, JAdamWConfig(),
                            JCompressionConfig(min_size=512),
                            jax.random.PRNGKey(0))
    np_st = jax.tree.map(np.asarray, jst)
    cfg = smoke_config(XLSTM)
    state = train_state_from_jax(np_st, cfg, CPU)
    res = state["residuals"]
    fresh = init_train_state(cfg, None, CompressionConfig(min_size=512),
                             device=CPU)
    assert {n for n, r in fresh["residuals"].items() if r is not None} == \
        {n for n, r in res.items() if r is not None}
    grads = {n: torch.zeros_like(p) for n, p in
             state["params"].named_parameters()}
    names = compressed_leaves(grads, res, CompressionConfig(min_size=512),
                              len(cfg.pattern))
    jleaves = {tuple(k.key for k in path) for path, leaf in
               jax.tree_util.tree_flatten_with_path(jst["residuals"])[0]}
    assert {reference_path(n, len(cfg.pattern))[0] for n in names} == jleaves
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(dj, 1, jst, compress=True, min_size=64)
    checkpoint.save(dt, 1, state, compress=True, min_size=64)
    for f in ("data.bin", "index.json"):
        with open(os.path.join(dj, "step_1", f), "rb") as a, \
                open(os.path.join(dt, "step_1", f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("fn", [
    lambda named, ccfg: reference_path(next(iter(named))),
    lambda named, ccfg: reference_layout(named),
    lambda named, ccfg: reference_numel(named),
    lambda named, ccfg: init_residuals(named, ccfg),
    lambda named, ccfg: compressed_leaves(named, named, ccfg),
    lambda named, ccfg: compress_decompress(named, named, ccfg),
], ids=["reference_path", "reference_layout", "reference_numel",
        "init_residuals", "compressed_leaves", "compress_decompress"])
def test_stacking_needs_the_pattern_length(fn):
    """Every function that stacks per-layer names takes the model's pattern
    length: none falls back to a one-position pattern, which would select
    other leaves for xLSTM's four positions."""
    named = {n: torch.zeros_like(p) for n, p in
             init_params(smoke_config(XLSTM), device=CPU).named_parameters()}
    with pytest.raises(TypeError, match="pattern_len"):
        fn(named, CompressionConfig(min_size=512))


def test_pattern_length_decides_the_stacked_sizes():
    """xLSTM's blocks stack by 4 positions: a leaf's stacked size is its
    layer's size times the groups. A one-position layout of its mixed
    positions is refused, not miscounted."""
    cfg = dataclasses.replace(smoke_config(XLSTM),
                              n_layers=2 * len(smoke_config(XLSTM).pattern))
    named = {n: torch.zeros_like(p) for n, p in
             init_params(cfg, device=CPU).named_parameters()}
    P = len(cfg.pattern)
    sizes = reference_numel(named, P)
    for n, t in named.items():
        groups = cfg.n_groups if n.startswith("blocks.") else 1
        assert sizes[n] == t.numel() * groups, n
    with pytest.raises(ValueError, match="not 0..n-1"):
        reference_numel(named, 1)


def test_checkpoint_of_layer_names_without_a_model_raises(tmp_path):
    """A per-layer name dict stacks by its model's pattern: saved without
    the model (or a train state holding it) it raises, and with the state
    it saves."""
    cfg = smoke_config(XLSTM)
    state = init_train_state(cfg, None, CompressionConfig(min_size=512),
                             device=CPU)
    with pytest.raises(ValueError, match="pattern"):
        checkpoint.save(str(tmp_path / "bare"), 0,
                        {"residuals": state["residuals"]})
    checkpoint.save(str(tmp_path / "state"), 0, state)
    assert checkpoint.latest_step(str(tmp_path / "state")) == 0
