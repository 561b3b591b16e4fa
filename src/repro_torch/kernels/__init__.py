"""Hand-written Hopper kernels of the port (``csrc/f2p_kernels.cu``), their
plain PyTorch versions, and the bit primitives they share."""
