"""repro_torch.autotune — the closed-form error models of the reference's
autotune package (DESIGN.md §8.1), copied because the sketch's
``choose_grid`` needs them, and the data half of its format policy
(``FormatPolicy``: the per-leaf formats of gradient compression and
checkpoints).

Calibration (``calibrate.py``) and the policy solver (``solve``) are not
ported yet (ROADMAP A9).
"""
from repro_torch.autotune.error_models import (Dist, HistogramDist,
                                               LogNormalDist, UniformDist,
                                               ZipfDist, expected_mse,
                                               mag_grid, max_rel_error)
from repro_torch.autotune.policy import (FormatPolicy, PolicyRule,
                                         leaf_path_str, path_from_keystr)

__all__ = ["Dist", "UniformDist", "LogNormalDist", "ZipfDist",
           "HistogramDist", "expected_mse", "max_rel_error", "mag_grid",
           "FormatPolicy", "PolicyRule", "leaf_path_str", "path_from_keystr"]
