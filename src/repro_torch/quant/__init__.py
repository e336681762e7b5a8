from repro_torch.quant.ptq import (QTensor, dequantize, pack_int4, quantize,  # noqa: F401
                                   quantize_rowwise, quantize_tree,
                                   tree_bytes, unpack_int4)
