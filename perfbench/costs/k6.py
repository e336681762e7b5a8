"""K6, the fused quantized decode attention (``fused_decode``, then the
head sum ``sum_heads_kernel``): x (B, D) bf16 through int8 wq (D, H), wk,
wv (D, Hkv) with their scales, rope, attention over the n_valid slots of
the cache before the write plus the token itself, and wo (H, D); writes
o (B, D) and the token's k1, v1 (B, nkv, dh).

    ops   = 2 B (D H + 2 D Hkv + H D)            (projections)
            + 4 B nh dh (n_valid + 1)            (attention)
    bytes = D H + 2 D Hkv + H D (int8 weights) + 4 (H + 2 Hkv + D)
            (scales) + 2 B D (x) + 2 * 2 B n_valid nkv dh (k, v)
            + 2 * 4 (dh / 2) (rope rows) + 2 B D (o) + 2 * 2 B nkv dh
            (k1, v1) + 2 * 4 B (n_valid, evicted slot)
"""
KERNELS = ("fused_decode", "sum_heads_kernel")
LAST = "sum_heads_kernel"


def cost(B: int, D: int, nh: int, nkv: int, dh: int, n_valid: int):
    H, Hkv = nh * dh, nkv * dh
    wts = D * H + 2 * D * Hkv + H * D
    ops = 2 * B * wts + 4 * B * nh * dh * (n_valid + 1)
    n_bytes = wts + 4 * (H + 2 * Hkv + D) + 2 * B * D \
        + 4 * B * n_valid * nkv * dh + 4 * dh + 2 * B * D \
        + 4 * B * nkv * dh + 8 * B
    return ops, n_bytes
