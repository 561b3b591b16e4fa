from repro_torch.core.f2p import F2PFormat, Flavor
from repro_torch.core.formats import (FPFormat, GridFormat, IntFormat,
                                      SEADFormat, bf16, fp16, named_format,
                                      tf32)
# NOTE: qtensor.quantize/dequantize are not re-exported bare — they would
# shadow the `repro_torch.core.quantize` submodule attribute on the package.
from repro_torch.core.qtensor import QTensor, block_scales, pow2_round_up
from repro_torch.core.quantize import (BlockQuantized, block_dequantize,
                                       block_quantize, minmax_quantize,
                                       quantization_mse)

__all__ = ["F2PFormat", "Flavor", "FPFormat", "GridFormat", "IntFormat",
           "SEADFormat", "bf16", "fp16", "tf32", "named_format", "QTensor",
           "block_scales", "pow2_round_up", "BlockQuantized",
           "block_dequantize", "block_quantize", "minmax_quantize",
           "quantization_mse"]
