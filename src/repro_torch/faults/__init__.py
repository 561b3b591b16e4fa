from repro_torch.faults.inject import CrashInjected, active, crashpoint

__all__ = ["CrashInjected", "active", "crashpoint"]
