"""repro_torch: the PyTorch/CUDA port of ``repro`` (F2P number format,
packed F2P KV cache, llama-dense serving) for NVIDIA Hopper.

Imports ``torch`` and ``numpy`` only — never ``jax`` and nothing of the
JAX package. Entry points run on ``cuda`` unless the caller passes a CPU
device; a tensor's device decides whether a hand-written kernel launches
(CUDA) or its plain PyTorch version runs (CPU).
"""
__version__ = "0.1.0"


def require_device(name):
    """``name`` as a ``torch.device`` for an entry point: asked for CUDA
    where there is no CUDA device, it raises rather than carry on on the
    CPU (a caller wanting the CPU asks for it)."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r}: no CUDA device here; ask for "
                           "the CPU (--device cpu) to run there")
    return dev
