"""``mamba2_decode`` (``mamba2_scan_step`` then ``mamba2_gate_norm``): one
Mamba2 layer's decode step between its projections, B rows, H heads of
P, state N, G groups, conv width K, d_inner = H P, C = d_inner + 2 G N
channels, the model type of ``esz`` bytes.  Inputs read once, outputs
written once (the scratch y between the two kernels not counted):

    bytes = 2 * 4 B H P N                  the float32 state, read and
                                           written
          + esz B (d_inner + C + H)        the projection: z, xBC, dt
          + 2 esz B (K - 1) C              the conv state, read and written
          + esz (K + 1) C + 12 H           taps, bias; dt_bias, A_log, D
          + esz d_inner + esz B d_inner    the norm's weight; the output
    ops   = 5 B H P N                      S * decay, (x dt) * B, +, S * C,
                                           the sum over N
"""
KERNELS = ("mamba2_scan_step", "mamba2_gate_norm")
LAST = "mamba2_gate_norm"


def cost(B: int, H: int, P: int, N: int, G: int, K: int, esz: int = 2):
    d_inner = H * P
    C = d_inner + 2 * G * N
    n_bytes = (8 * B * H * P * N + esz * B * (d_inner + C + H)
               + 2 * esz * B * (K - 1) * C + esz * (K + 1) * C + 12 * H
               + esz * d_inner + esz * B * d_inner)
    return 5 * B * H * P * N, n_bytes
