"""Port parity, sharding rules: the port's logical rules, parameter and
cache specs, ``sanitize_spec`` and the head-shard / sequence-parallel
variants against the JAX reference, in one process (no ranks: specs are
shapes and names only, the reference's side runs on abstract shapes and a
stand-in mesh that has sizes).

Tolerances and why:
- ``param_specs`` / ``cache_specs`` / ``sanitize_spec`` /
  ``make_rules`` / ``rules_for``: EQUAL, leaf for leaf, for all ten smoke
  configs under (2, 2) rules with ``fsdp`` on and off (the reference's
  leading scan-group entry dropped: the port does not stack layers);
- ``_mha_attention`` / ``_mha_chunked`` against the reference's on the
  same inputs: rtol = atol = 1e-5 (f32, other summation orders), the
  tolerance ``tests/test_opt_variants.py`` holds them to against GQA;
- each variant's loss and gradients against the reference's same variant
  and against the port's baseline: loss within 1e-4, gradient leaves
  rtol 2e-3, atol 2e-4 (``tests/test_opt_variants.py``'s tolerances:
  broadcast-KV attention sums in other orders; the constraints are
  no-ops on one process);
- the MoE ``opt_seq_par`` flag changes no bit of the port's loss
  (constraints act on DTensors only).
"""
import dataclasses
import types

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import smoke_config as jsmoke
from repro.launch import shardings as JS
from repro.models import attention as JA
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import train_forward as jtrain_forward
from repro.models.config import BlockSpec as JBlockSpec
from repro.models.config import ModelConfig as JModelConfig
from repro.models.sharding import make_rules as jmake_rules
from repro.models.sharding import param_specs as jparam_specs
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import CompressionConfig as JCompressionConfig
from repro.train import init_train_state as jinit_train_state
from repro_torch.configs import smoke_config
from repro_torch.launch import shardings as S
from repro_torch.launch.train import train_configs
from repro_torch.models import attention as A
from repro_torch.models import init_caches, train_forward
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.convert import params_from_jax, reference_path
from repro_torch.models.sharding import make_rules, param_specs

MESH = {"data": 2, "model": 2}
# the reference's helpers read .shape (sizes) and .axis_names of a mesh
JMESH = types.SimpleNamespace(shape=MESH, axis_names=("data", "model"))
CPU = "cpu"


def _jspec(p) -> tuple:
    return tuple(p)


def _ref_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("fsdp", [False, True], ids=["nofsdp", "fsdp"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_sanitize_equal_reference(arch, fsdp):
    cfg = dataclasses.replace(smoke_config(arch), fsdp=fsdp)
    jcfg = dataclasses.replace(jsmoke(arch), fsdp=fsdp)
    rules = make_rules(fsdp=fsdp)
    assert rules == jmake_rules(fsdp=fsdp)
    assert S.rules_for(cfg, MESH, "train_4k") == \
        JS.rules_for(jcfg, JMESH, "train_4k")
    jp = jax.eval_shape(lambda k: jinit_params(jcfg, k),
                        jax.random.PRNGKey(0))
    jspecs = jparam_specs(jp, rules)
    named = dict(S.abstract_params(cfg).named_parameters())
    got = param_specs(named, rules)
    assert set(got) == set(named)
    P = len(cfg.pattern)
    for n, p in named.items():
        path, layer = reference_path(n, P)
        want, leaf = _jspec(_ref_leaf(jspecs, path)), _ref_leaf(jp, path)
        wsan = JS.sanitize_spec(leaf.shape, _ref_leaf(jspecs, path), JMESH)
        if layer is not None:      # the reference's scan-group dim
            assert want[0] is None and wsan[0] is None, n
            want, wsan = want[1:], tuple(wsan)[1:]
        assert got[n] == want, n
        assert S.sanitize_spec(tuple(p.shape), got[n], MESH) == \
            tuple(wsan), n
    # the train state: moments follow the parameters, residuals too, a
    # None residual (a leaf below min_size) stays None, as the reference's
    _, ccfg, _, _ = train_configs(cfg, arch=arch, steps=1)
    sh, specs = S.train_state_specs(cfg, None, ccfg, MESH, rules)
    jst = jax.eval_shape(lambda k: jinit_train_state(
        jcfg, JAdamWConfig(), JCompressionConfig(
            min_size=ccfg.min_size, fmt=None, block=ccfg.block), k),
        jax.random.PRNGKey(0))
    assert specs["opt"]["mu"] == specs["opt"]["nu"] == specs["params"]
    for n in named:
        path, _ = reference_path(n, P)
        assert (specs["residuals"][n] is None) == \
            (_ref_leaf(jst["residuals"], path) is None), n
        if specs["residuals"][n] is not None:
            assert sh["residuals"][n].spec == sh["params"][n].spec


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "f2p"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, quantized):
    cfg, jcfg = smoke_config(arch), jsmoke(arch)
    for shape_name in ("decode_32k", "long_500k"):
        rules = S.rules_for(cfg, MESH, shape_name)
        jr = JS.rules_for(jcfg, JMESH, shape_name)
        assert rules == jr
        jct = jax.eval_shape(lambda: jinit_caches(
            jcfg, 2, 16, quantized_kv=quantized))
        want = JS.cache_specs(jct, jr)
        ct = init_caches(cfg, 2, 16, quantized_kv=quantized, device="meta")
        got = S.cache_specs(ct, rules)
        assert set(got) == set(want)
        for pos in got:
            assert set(got[pos]) == set(want[pos]), pos
            for name, sp in got[pos].items():
                w = want[pos][name]
                if isinstance(sp, dict):
                    assert (sp["codes"], sp["scales"]) == (
                        _jspec(w.codes), _jspec(w.scales)), (pos, name)
                else:
                    assert sp == _jspec(w), (pos, name)


def test_sanitize_spec_cases_equal_reference():
    from jax.sharding import PartitionSpec as JP

    cases = [((8, 6), ("data", "model")), ((6, 8), (("data", "model"),)),
             ((3, 4, 5), (None, "model")), ((12,), ("model",)),
             ((4, 4, 4), ("data", None, ("data", "model")))]
    for shape, spec in cases:
        want = tuple(JS.sanitize_spec(shape, JP(*spec), JMESH))
        assert S.sanitize_spec(shape, spec, MESH) == want, (shape, spec)
    fake = {"pod": 2, "data": 2, "model": 4}
    jfake = types.SimpleNamespace(shape=fake,
                                  axis_names=("pod", "data", "model"))
    for shape, spec in [((8, 16), (("pod", "data"), "model")),
                        ((6, 16), (("pod", "data"), "model"))]:
        assert S.sanitize_spec(shape, spec, fake) == tuple(
            JS.sanitize_spec(shape, JP(*spec), jfake))
    assert S.rules_for(smoke_config("llama3_2_3b"), fake, "train_4k") == \
        JS.rules_for(jsmoke("llama3_2_3b"), jfake, "train_4k")


# ---------------------------------------------------------------------------
# opt_head_shard / opt_seq_par (tests/test_opt_variants.py's cases)
# ---------------------------------------------------------------------------
BASE = dict(name="v", n_layers=2, d_model=64, n_heads=6, n_kv_heads=2,
            d_ff=128, vocab_size=128, dtype="float32", remat=False)
VARIANTS = {"head_shard": dict(opt_head_shard=True),
            "seq_par": dict(opt_seq_par=True),
            "all": dict(opt_head_shard=True, opt_seq_par=True,
                        attn_impl="chunked", attn_chunk=8)}


def test_head_shard_attention_matches_reference():
    rng = np.random.default_rng(0)
    B, S_, H, K, hd = 2, 24, 6, 2, 16
    q, k, v = (rng.normal(size=(B, S_, n, hd)).astype(np.float32)
               for n in (H, K, K))
    kb, vb = JA._broadcast_kv(jnp.asarray(k), H), JA._broadcast_kv(
        jnp.asarray(v), H)
    tk, tv = A._broadcast_kv(torch.from_numpy(k), H), A._broadcast_kv(
        torch.from_numpy(v), H)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(kb))
    tq = torch.from_numpy(q)
    for causal, kv_len in ((True, None), (False, 17)):
        want = JA._mha_attention(jnp.asarray(q), kb, vb, causal=causal,
                                 kv_len=kv_len)
        got = A._mha_attention(tq, tk, tv, causal=causal, kv_len=kv_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        want = JA._mha_chunked(jnp.asarray(q), kb, vb, causal=causal,
                               chunk=8, kv_len=kv_len)
        got = A._mha_chunked(tq, tk, tv, causal=causal, chunk=8,
                             kv_len=kv_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    gqa = A.naive_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                            causal=True)
    np.testing.assert_allclose(A._mha_attention(tq, tk, tv, causal=True),
                               gqa, rtol=1e-5, atol=1e-5)


def _jax_loss_and_grads(jcfg):
    params = jinit_params(jcfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                              jcfg.vocab_size)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, g = jax.value_and_grad(
        lambda p: jtrain_forward(p, batch, jcfg)[0])(params)
    np_params = jax.tree.map(np.asarray, params)
    return float(loss), g, np_params, jax.tree.map(np.asarray, batch)


def _port_loss_and_grads(cfg, np_params, batch):
    model = params_from_jax(np_params, cfg, device=CPU)
    model.requires_grad_(True)
    loss, _ = train_forward(model, {k: torch.from_numpy(np.array(v)) for
                                    k, v in batch.items()}, cfg)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  model.named_parameters()}


def _assert_grads(port: dict, jgrads, P: int):
    for n, g in port.items():
        path, layer = reference_path(n, P)
        want = np.asarray(_ref_leaf(jgrads, path))
        want = want if layer is None else want[layer]
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-3, atol=2e-4,
                                   err_msg=n)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_loss_and_grads_match_reference(variant):
    knobs = VARIANTS[variant]
    cfg = ModelConfig(**BASE, **knobs)
    jcfg = JModelConfig(**BASE, **knobs)
    jl, jg, np_params, batch = _jax_loss_and_grads(jcfg)
    l1, g1 = _port_loss_and_grads(cfg, np_params, batch)
    assert abs(l1 - jl) < 1e-4, (l1, jl)
    _assert_grads(g1, jg, len(cfg.pattern))
    l0, g0 = _port_loss_and_grads(ModelConfig(**BASE), np_params, batch)
    assert abs(l0 - l1) < 1e-4, (l0, l1)
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=2e-3,
                                   atol=2e-4, err_msg=n)


def test_moe_sp_flag_preserves_output():
    moe = dict(pattern=(BlockSpec("attn", "moe"),), n_experts=4,
               experts_per_token=2, n_shared_experts=1, capacity_factor=2.0)
    jmoe = dict(moe, pattern=(JBlockSpec("attn", "moe"),))
    jl, _, np_params, batch = _jax_loss_and_grads(
        JModelConfig(**BASE, **jmoe, opt_seq_par=True))
    l0, _ = _port_loss_and_grads(ModelConfig(**BASE, **moe), np_params,
                                 batch)
    l1, _ = _port_loss_and_grads(ModelConfig(**BASE, **moe,
                                             opt_seq_par=True),
                                 np_params, batch)
    assert l0 == l1
    assert abs(l1 - jl) < 1e-4, (l1, jl)


def test_roundtrip_gathered_leaves_full_configs():
    """The leaves whose round trip the sharded step gathers at (2, 2): the
    full configs' compressed leaves with a split last dim whose local width
    is not a multiple of the block (ROADMAP's table)."""
    from repro_torch.configs import full_config

    def gathered(arch, fsdp):
        cfg = dataclasses.replace(full_config(arch), fsdp=fsdp)
        _, ccfg, _, _ = train_configs(cfg, arch=arch, steps=1)
        names = S.roundtrip_gathered(cfg, ccfg, MESH,
                                     S.rules_for(cfg, MESH, "train_4k"))
        return sorted({n.split(".")[-1] if n.startswith("blocks.")
                       else n for n in names})

    assert gathered("llama3_2_3b", True) == []
    assert gathered("xlstm_125m", False) == []
    assert gathered("minicpm3_4b", False) == ["lm_head"]
    assert gathered("codeqwen1_5_7b", False) == []
    assert gathered("codeqwen1_5_7b", True) == ["gate", "up"]
    assert gathered("internvl2_1b", False) == ["wk", "wq", "wv"]


def test_production_mesh_names_its_shape():
    """The production meshes need 256 (512) ranks: a world of another size
    is refused, naming the shape; ``data_axes`` folds "pod" into data."""
    from repro_torch.launch import mesh as M

    for multi_pod, shape in ((False, "(16, 16)"), (True, "(2, 16, 16)")):
        with pytest.raises(ValueError, match=shape.replace("(", r"\(")
                           .replace(")", r"\)")):
            M.make_production_mesh(multi_pod=multi_pod)
    assert M.data_axes({"data": 16, "model": 16}) == ("data",)
    assert M.data_axes({"pod": 2, "data": 16, "model": 16}) == ("pod",
                                                                 "data")
