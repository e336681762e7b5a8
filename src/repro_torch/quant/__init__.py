from repro_torch.quant.ptq import (QTensor, dequantize, pack_int4, quantize,  # noqa: F401
                                   quantize_rowwise, quantize_tree,
                                   tree_bytes, unpack_int4)
from repro_torch.quant.calibration import (attach_alphas, calibrate,  # noqa: F401
                                           measure_alpha, measure_beta,
                                           measure_dppl, measure_swap_cost,
                                           measured_methods, model_ppl,
                                           synthetic_eval_batch)
