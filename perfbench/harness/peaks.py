"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity), at the full 700 W power limit."""

BF16_FLOPS = 989e12          # bf16 / fp16 tensor-core FLOP/s
INT8_OPS = 1979e12           # int8 tensor-core OP/s
HBM_BYTES_PER_S = 3.35e12    # HBM3 bandwidth
DEVICE_KIND = "NVIDIA H100"


def bound_s(ops: float, n_bytes: float, ops_per_s: float = BF16_FLOPS):
    """The least time the work can take: the larger of its operations
    over the peak rate and its bytes over the memory bandwidth."""
    return max(ops / ops_per_s, n_bytes / HBM_BYTES_PER_S)
