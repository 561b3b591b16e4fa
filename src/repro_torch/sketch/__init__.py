"""Batched F2P sketch engine (port of ``repro.sketch``): count-min over F2P
grid-counter cells with the stochastic advance on the card (DESIGN.md §6).
"""
from repro_torch.sketch.hashing import (fold_u64, hash_rows, hash_rows_np,
                                        make_hash_params)
from repro_torch.sketch.sketch import F2PSketch, SketchConfig, choose_grid

__all__ = ["F2PSketch", "SketchConfig", "choose_grid", "hash_rows",
           "hash_rows_np", "make_hash_params", "fold_u64"]
