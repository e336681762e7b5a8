"""The least bytes and operations of one decode step of the published
Zamba2 block (``reference/zamba2.py``), B rows at valid length n, as the
``zamba2_step_roofline`` metric divides them.

    weights  = the matrices at one byte each, as int8 at W8A16, each
               site re-reading its shared block:
               L (D (d_inner + C + H) + d_inner D + K C)          Mamba2
             + n_sites (3 d_in nh dh + nh dh D + 3 D F             block
                        + r (D + 2 F) + D D)                       adapter,
                                                                   linear
             + V D                                                 logits
    state    = 2 L B (4 H P N + 2 (K - 1) C)   float32 SSM state and the
               bf16 conv state, each read and written once
    kv       = n_sites B n 2 nkv dh 2          the sites' bf16 k, v at
               valid length n
    ops      = 2 B (weights) + 4 L B H P N + 4 n_sites B nh dh n

The weights are counted at int8 though the program serves the hybrid
family's tree dequantized to bf16: the count is a floor for any route
the weights may take.  ``state_bytes`` is the count the program reports
as ``ssm_state_bytes`` at each capture.
"""


def _dims(model):
    s = model["ssm"]
    D = model["d_model"]
    d_inner = s["expand"] * D
    H = d_inner // s["head_dim"]
    C = d_inner + 2 * s["n_groups"] * s["d_state"]
    return D, d_inner, H, C, 2 * D          # the sites read concat(x, e)


def weight_bytes(model) -> int:
    D, d_inner, H, C, d_in = _dims(model)
    hy, K, F = model["hybrid"], model["ssm"]["conv_width"], model["d_ff"]
    nh, nkv, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    mamba = D * (d_inner + C + H) + d_inner * D + K * C
    site = ((nh + 2 * nkv) * dh * d_in + nh * dh * D + 3 * D * F
            + hy["adapter_rank"] * (D + 2 * F) + D * D)
    return model["n_layers"] * mamba + len(hy["sites"]) * site \
        + model["vocab"] * D


def state_bytes(model, B: int) -> int:
    D, d_inner, H, C, d_in = _dims(model)
    s = model["ssm"]
    per_row = 4 * H * s["head_dim"] * s["d_state"] \
        + 2 * (s["conv_width"] - 1) * C
    return 2 * model["n_layers"] * B * per_row


def cost(model, B: int, n_valid: int):
    """(ops, bytes) of one decode step of B rows at valid length n_valid."""
    D, d_inner, H, C, d_in = _dims(model)
    s = model["ssm"]
    nh, nkv, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    n_sites = len(model["hybrid"]["sites"])
    kv = n_sites * B * n_valid * 2 * nkv * dh * 2
    ops = 2 * B * weight_bytes(model) \
        + 4 * model["n_layers"] * B * H * s["head_dim"] * s["d_state"] \
        + 4 * n_sites * B * nh * dh * n_valid
    return ops, weight_bytes(model) + state_bytes(model, B) + kv
