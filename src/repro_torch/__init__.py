"""repro_torch: the PyTorch/CUDA port of ``repro`` (F2P number format,
packed F2P KV cache, llama-dense serving) for NVIDIA Hopper.

Imports ``torch`` and ``numpy`` only — never ``jax`` and nothing of the
JAX package. Entry points run on ``cuda`` unless the caller passes a CPU
device; a tensor's device decides whether a hand-written kernel launches
(CUDA) or its plain PyTorch version runs (CPU).
"""
__version__ = "0.1.0"
