from repro_torch.configs.registry import (ARCH_IDS, SHAPES, canon,
                                          default_policy, full_config,
                                          get_arch, input_specs,
                                          shape_is_applicable, smoke_config)

__all__ = ["ARCH_IDS", "SHAPES", "canon", "default_policy", "full_config",
           "get_arch", "input_specs", "shape_is_applicable", "smoke_config"]
