from repro_torch.models.config import BlockSpec, ModelConfig, dense_pattern
from repro_torch.models.model import (Model, decode_step, encode,
                                      init_caches, init_params, kv_format,
                                      layer_cache, prefill, train_forward)

__all__ = ["BlockSpec", "ModelConfig", "dense_pattern", "Model",
           "decode_step", "encode", "init_caches", "init_params",
           "kv_format", "layer_cache", "prefill", "train_forward"]
