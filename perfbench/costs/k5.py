"""K5, K4's body reading the cache through a block table: q (B, nh, dh)
against the first n_valid slots of each row, slot j in page
``table[b, j // bt]``; the table (B, n_b) int32 is read whole.

    ops   = 4 B nh dh n_valid
    bytes = 2 * 2 B n_valid nkv dh + 2 B nh dh (q) + 2 B nh dh (out)
            + 4 B (n_valid) + 4 B n_b (table)
"""
KERNELS = ("fd_split", "fd_combine")
LAST = "fd_combine"


def cost(B: int, nh: int, nkv: int, dh: int, n_valid: int, n_b: int):
    ops = 4 * B * nh * dh * n_valid
    n_bytes = 4 * B * n_valid * nkv * dh + 4 * B * nh * dh + 4 * B \
        + 4 * B * n_b
    return ops, n_bytes
