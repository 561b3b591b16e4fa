"""Architecture lookup (port of the ``full_config``/``smoke_config`` part of
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
