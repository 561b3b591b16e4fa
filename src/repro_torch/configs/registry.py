"""Architecture registry (port of ``repro.configs.registry``): ``--arch``
resolution, the assigned shape suite ``SHAPES`` and ``input_specs``, which
describes every model input of an (arch, shape) cell as ``meta`` tensors
(no storage), and the per-model default format policies."""
from __future__ import annotations

import importlib

import torch

ARCH_IDS = [
    "minitron_4b",
    "llama3_2_3b",
    "minicpm3_4b",
    "codeqwen1_5_7b",
    "whisper_large_v3",
    "internvl2_1b",
    "llama4_maverick_400b",
    "llama4_scout_17b",
    "jamba_1_5_large",
    "xlstm_125m",
]

# assigned shape suite: name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_arch(arch: str):
    name = canon(arch)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def full_config(arch: str):
    return get_arch(arch).full()


def smoke_config(arch: str):
    return get_arch(arch).smoke()


# ---------------------------------------------------------------------------
# Per-model default format policies (repro_torch.autotune.policy). Rule-path
# domains are the call sites' conventions: "grad/*" (gradient compression),
# "kv/*" (quantized KV cache), "ckpt/*" (checkpoint payload leaves), "fl/*"
# (federated deltas). The reference's hand-picked defaults, rule for rule.
# ---------------------------------------------------------------------------
_BASE_POLICY_RULES = (
    # "grad*" (not "grad/*") so the bare domain root "grad" matches too
    ("grad*", "f2p_sr_2_8s", 128),
    ("kv*", "f2p_sr_2_8s", 0),
    ("ckpt*", "f2p_sr_2_16s", 128),
    ("fl*", "f2p_sr_2_8s", 128),
)

# per-arch overrides, matched before the base rules
_ARCH_POLICY_RULES = {
    # MoE stacks: expert FF grads are wide and smooth — bigger blocks halve
    # the scale overhead at unchanged accuracy
    "llama4_maverick_400b": (("grad/*ff*", "f2p_sr_2_8s", 256),),
    "llama4_scout_17b": (("grad/*ff*", "f2p_sr_2_8s", 256),),
    "jamba_1_5_large": (("grad/*ff*", "f2p_sr_2_8s", 256),),
    # enc-dec audio: encoder KV ranges are narrow — spend the hyper-exp bit
    # on mantissa (H=1) instead of range
    "whisper_large_v3": (("kv/*", "f2p_sr_1_8s", 0),),
}


def default_policy(arch: str):
    """The arch's default :class:`repro_torch.autotune.policy.FormatPolicy`."""
    from repro_torch.autotune.policy import FormatPolicy, PolicyRule

    name = canon(arch)
    get_arch(name)   # raises for an unknown arch
    rules = _ARCH_POLICY_RULES.get(name, ()) + _BASE_POLICY_RULES
    return FormatPolicy(rules=tuple(PolicyRule(pattern=p, fmt=f, block=b)
                                    for p, f, b in rules))


def shape_is_applicable(cfg, shape_name: str) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic stacks."""
    if shape_name == "long_500k" and not cfg.is_subquadratic:
        return False, ("pure full-attention arch: long_500k needs "
                       "sub-quadratic mixing (skipped per assignment)")
    return True, ""


def input_specs(cfg, shape_name: str, *, sharding_fn=None) -> dict:
    """Stand-ins for every model input of (arch, shape): ``meta`` tensors
    of the reference's keys, shapes and dtypes (int32 tokens, bf16
    ``frames`` / ``patches``), nothing allocated. The patch embeddings
    take ``vision_tokens`` of the sequence; the encoder's frames come on
    top. ``sharding_fn(logical_axes)`` (e.g. a ``NamedSharding`` from the
    rules, or None) is called with each input's logical axes, the
    reference's, and its result is attached as the stand-in's
    ``sharding`` attribute."""
    seq, gbatch, kind = SHAPES[shape_name]

    def spec(shape, dtype, axes):
        t = torch.empty(shape, dtype=dtype, device="meta")
        if sharding_fn is not None:
            t.sharding = sharding_fn(axes)
        return t

    text_seq = seq
    extras = {}
    if cfg.frontend == "vision":
        text_seq = seq - cfg.vision_tokens
        extras["patches"] = spec((gbatch, cfg.vision_tokens, cfg.d_model),
                                 torch.bfloat16, ("batch", None, None))
    if cfg.is_encdec:
        extras["frames"] = spec((gbatch, cfg.encoder_seq, cfg.d_model),
                                torch.bfloat16, ("batch", None, None))
    if kind == "train":
        return dict(tokens=spec((gbatch, text_seq), torch.int32,
                                ("batch", "seq")),
                    labels=spec((gbatch, text_seq), torch.int32,
                                ("batch", "seq")), **extras)
    if kind == "prefill":
        return dict(tokens=spec((gbatch, text_seq), torch.int32,
                                ("batch", "seq")), **extras)
    # decode: one new token against a cache of `seq`
    return dict(token=spec((gbatch, 1), torch.int32, ("batch", None)),
                **extras)
