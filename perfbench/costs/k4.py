"""K4, split-KV decode attention over the slab cache (``fd_split`` then
``fd_combine``): q (B, nh, dh) against the first n_valid slots of k, v
(B, W, nkv, dh), bf16, one call a layer.

    ops   = 4 B nh dh n_valid                    (q.k and p.v)
    bytes = 2 * 2 B n_valid nkv dh (k, v valid slots) + 2 B nh dh (q)
            + 2 B nh dh (out) + 4 B (n_valid)
"""
KERNELS = ("fd_split", "fd_combine")
LAST = "fd_combine"


def cost(B: int, nh: int, nkv: int, dh: int, n_valid: int):
    ops = 4 * B * nh * dh * n_valid
    n_bytes = 4 * B * n_valid * nkv * dh + 4 * B * nh * dh + 4 * B
    return ops, n_bytes
