from repro_torch.serve.arch import (SupportedArchitecture, arch_for,
                                    make_batched_decode_step,
                                    make_batched_prefill,
                                    register_architecture, sample_tokens)
from repro_torch.serve.batched import BatchedEngine, BatchedServeConfig, Request
from repro_torch.serve.engine import (Engine, ServeConfig, SketchIngestEngine,
                                      make_prefill_step, make_serve_step)
from repro_torch.serve.paging import HostKV, PagedKVPool, PageTable, PoolExhausted

__all__ = [
    "Engine", "ServeConfig", "SketchIngestEngine", "make_prefill_step",
    "make_serve_step", "BatchedEngine",
    "BatchedServeConfig", "Request",
    "PagedKVPool", "PageTable", "HostKV", "PoolExhausted",
    "SupportedArchitecture", "arch_for", "make_batched_prefill",
    "make_batched_decode_step", "register_architecture", "sample_tokens",
]
