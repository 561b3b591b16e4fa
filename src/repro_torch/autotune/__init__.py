"""repro_torch.autotune — the closed-form error models, streaming
calibration and the format-policy engine of the reference's autotune
package (DESIGN.md §8): ``error_models`` (copied), ``calibrate`` (device
histograms of block-normalized magnitudes), ``policy`` (``FormatPolicy``
and the budgeted solver ``solve``).
"""
from repro_torch.autotune.calibrate import (NORM_SPEC, HistSpec, empty_state,
                                            histogram_of, leaf_summary,
                                            scale_rms, to_dist, update,
                                            update_tree)
from repro_torch.autotune.error_models import (Dist, HistogramDist,
                                               LogNormalDist, UniformDist,
                                               ZipfDist, expected_mse,
                                               mag_grid, max_rel_error)
from repro_torch.autotune.policy import (FormatPolicy, LeafSpec, PolicyRule,
                                         candidate_formats, leaf_path_str,
                                         path_from_keystr, solve)

__all__ = ["Dist", "UniformDist", "LogNormalDist", "ZipfDist",
           "HistogramDist", "expected_mse", "max_rel_error", "mag_grid",
           "HistSpec", "NORM_SPEC", "empty_state", "update", "update_tree",
           "to_dist", "scale_rms", "histogram_of", "leaf_summary",
           "FormatPolicy", "PolicyRule", "LeafSpec", "solve",
           "candidate_formats", "leaf_path_str", "path_from_keystr"]
