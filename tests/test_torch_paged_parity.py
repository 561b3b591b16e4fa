"""Port: the card check's paged == dense attention parity on the CPU.

``chip_smoke.attention_parity`` is phase 3's bitwise check of B1 (paged,
a shuffled page table) against B2 (dense, the pages gathered) at the
serving decode shape: 8 rows x 8 kv heads, G = 3, head_dim 128, kv_len
512..1024 over 8-token pages, ``f2p_sr_2_8s``. On the CPU it runs the
plain versions at the same inputs: decode, a page table cut to the live
span and a causal 4-query call must be EQUAL (the same blocks of the same
positions in the same order), and the causal call within rtol = atol =
1e-5 of the plain paged version (the check's own tolerance). Run inside
the full test suite, it repeats the check under the suite's load.
"""
import importlib.util
import os

import _torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_card_check_paged_equals_dense_on_cpu():
    res = _chip_smoke().attention_parity("cpu")
    assert res["paged"].shape == (8, 1, 24, 128)
    assert bool(res["paged"].isfinite().all())
