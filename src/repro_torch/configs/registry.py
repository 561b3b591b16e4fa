"""Architecture lookup and default format policies (port of the
``full_config``/``smoke_config``/``default_policy`` part of
``repro.configs.registry``). The llama-dense, MoE, mamba-hybrid (jamba)
and xLSTM configs are ported; the two archs with a frontend (whisper,
internvl2) raise ``NotImplementedError`` naming their ROADMAP item."""
from __future__ import annotations

import importlib

# the reference's ARCH_IDS, in its order, restricted to the ported archs
ARCH_IDS = [
    "minitron_4b",
    "llama3_2_3b",
    "minicpm3_4b",
    "codeqwen1_5_7b",
    "llama4_maverick_400b",
    "llama4_scout_17b",
    "jamba_1_5_large",
    "xlstm_125m",
]

# the reference's archs still to port, with the ROADMAP item of each
_NOT_PORTED = {
    "whisper_large_v3": "A13f",
    "internvl2_1b": "A13b",
}


def canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_arch(arch: str):
    name = canon(arch)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported (ROADMAP {_NOT_PORTED[name]}); "
            f"ported: {ARCH_IDS}")
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

# per-arch overrides, matched before the base rules (the reference's, for
# the ported archs; whisper's comes with ROADMAP A13f)
_ARCH_POLICY_RULES = {
    # MoE stacks: expert FF grads are wide and smooth — bigger blocks halve
    # the scale overhead at unchanged accuracy
    "llama4_maverick_400b": (("grad/*ff*", "f2p_sr_2_8s", 256),),
    "llama4_scout_17b": (("grad/*ff*", "f2p_sr_2_8s", 256),),
    "jamba_1_5_large": (("grad/*ff*", "f2p_sr_2_8s", 256),),
}


def default_policy(arch: str):
    """The arch's default :class:`repro_torch.autotune.policy.FormatPolicy`."""
    from repro_torch.autotune.policy import FormatPolicy, PolicyRule

    name = canon(arch)
    get_arch(name)   # raises for an arch the port does not have
    rules = _ARCH_POLICY_RULES.get(name, ()) + _BASE_POLICY_RULES
    return FormatPolicy(rules=tuple(PolicyRule(pattern=p, fmt=f, block=b)
                                    for p, f, b in rules))
