"""repro_torch.autotune — the closed-form error models of the reference's
autotune package (DESIGN.md §8.1), copied because the sketch's
``choose_grid`` needs them.

Calibration (``calibrate.py``) and the format-policy engine (``policy.py``)
are not ported yet (ROADMAP A9).
"""
from repro_torch.autotune.error_models import (Dist, HistogramDist,
                                               LogNormalDist, UniformDist,
                                               ZipfDist, expected_mse,
                                               mag_grid, max_rel_error)

__all__ = ["Dist", "UniformDist", "LogNormalDist", "ZipfDist",
           "HistogramDist", "expected_mse", "max_rel_error", "mag_grid"]
