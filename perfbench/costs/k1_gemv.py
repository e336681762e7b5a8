"""K1's decode GEMV (``qmm_a16_gemv``): out (M, N) bf16 = x (M, K) bf16
@ (q (K, N) int8 * scale (N,) float32).

    ops   = 2 M K N
    bytes = K N (q) + 4 N (scale) + 2 M K (x) + 2 M N (out)
"""
KERNELS = ("qmm_a16_gemv",)
LAST = "qmm_a16_gemv"        # one event per call


def cost(M: int, K: int, N: int):
    return 2 * M * K * N, K * N + 4 * N + 2 * M * K + 2 * M * N


def step_shapes(model: dict, fused: bool):
    """(K, N) of the GEMV calls of one decode step: per layer wq, wk, wv,
    wo, w1, w2; on the fused tier (K6) the attention's four run inside
    K6, and w1, w2 remain."""
    D, F = model["d_model"], model["d_ff"]
    H = model["n_heads"] * model["d_head"]
    Hkv = model["n_kv_heads"] * model["d_head"]
    per_layer = [(D, F), (F, D)]
    if not fused:
        per_layer = [(D, H), (D, Hkv), (D, Hkv), (H, D)] + per_layer
    return per_layer * model["n_layers"]
