from repro_torch.data.pipeline import DataConfig, global_batch, host_batch

__all__ = ["DataConfig", "global_batch", "host_batch"]
