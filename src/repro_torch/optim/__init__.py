from repro_torch.optim.adamw import (AdamWConfig, apply_updates, global_norm,
                                     init_state, lr_at)
from repro_torch.optim.compress import (CompressionConfig,
                                        compress_decompress,
                                        compressed_psum, init_residuals)

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_state",
           "lr_at", "CompressionConfig", "compress_decompress",
           "compressed_psum", "init_residuals"]
