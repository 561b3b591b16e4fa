from repro_torch.configs.registry import (ARCH_IDS, canon, default_policy,
                                          full_config, get_arch,
                                          smoke_config)

__all__ = ["ARCH_IDS", "canon", "default_policy", "full_config", "get_arch",
           "smoke_config"]
