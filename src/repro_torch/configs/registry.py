"""Architecture lookup and default format policies (port of the
``full_config``/``smoke_config``/``default_policy`` part of
``repro.configs.registry``). Only llama3_2_3b is ported; every other arch
of the reference raises ``NotImplementedError`` (ROADMAP A13)."""
from __future__ import annotations

import importlib

ARCH_IDS = ["llama3_2_3b"]


def canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_arch(arch: str):
    name = canon(arch)
    if name not in ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported (ROADMAP A13); ported: {ARCH_IDS}")
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

# per-arch overrides, matched before the base rules (none for the ported
# arch; the reference's MoE and whisper overrides come with ROADMAP A13)
_ARCH_POLICY_RULES: dict[str, tuple] = {}


def default_policy(arch: str):
    """The arch's default :class:`repro_torch.autotune.policy.FormatPolicy`."""
    from repro_torch.autotune.policy import FormatPolicy, PolicyRule

    name = canon(arch)
    get_arch(name)   # raises for an arch the port does not have
    rules = _ARCH_POLICY_RULES.get(name, ()) + _BASE_POLICY_RULES
    return FormatPolicy(rules=tuple(PolicyRule(pattern=p, fmt=f, block=b)
                                    for p, f, b in rules))
