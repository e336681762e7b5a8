"""K1's prefill matmul on the tensor cores (``qmm_tc``): out (M, N) bf16
= x (M, K) bf16 @ (q (K, N) int8 * scale (N,) float32), M = the rows of
the padded batch (batch capacity x s').

    ops   = 2 M K N
    bytes = K N (q) + 4 N (scale) + 2 M K (x) + 2 M N (out)
"""
KERNELS = ("qmm_tc",)
LAST = "qmm_tc"


def cost(M: int, K: int, N: int):
    return 2 * M * K * N, K * N + 4 * N + 2 * M * K + 2 * M * N


def prefill_shapes(model: dict):
    """(K, N) of the calls of one prefill: per layer wq, wk, wv, wo, w1,
    w2 (prefill never takes the fused tier)."""
    D, F = model["d_model"], model["d_ff"]
    H = model["n_heads"] * model["d_head"]
    Hkv = model["n_kv_heads"] * model["d_head"]
    return [(D, H), (D, Hkv), (D, Hkv), (H, D), (D, F), (F, D)] \
        * model["n_layers"]
