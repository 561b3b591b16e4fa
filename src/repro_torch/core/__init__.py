from repro_torch.core.f2p import F2PFormat, Flavor
from repro_torch.core.formats import (FPFormat, GridFormat, IntFormat,
                                      SEADFormat, bf16, fp16, named_format,
                                      tf32)
from repro_torch.core.qtensor import QTensor, block_scales, pow2_round_up

__all__ = ["F2PFormat", "Flavor", "FPFormat", "GridFormat", "IntFormat",
           "SEADFormat", "bf16", "fp16", "tf32", "named_format", "QTensor",
           "block_scales", "pow2_round_up"]
