"""Model FLOPs of served tokens (``step_mfu``): the work a served request
needs, not what the padded batch computes.

A token at context c (the keys it attends, itself included) costs

    2 L (D H + 2 D Hkv + H D + 2 D F)    (the layers' matmuls)
    + 4 L nh dh c                        (q.k and p.v)

and a token whose logits are read adds 2 D V (the tied unembedding).  A
prompt of s tokens reads one row of logits and attends causally, so c
runs 1..s.  Generated token 0 comes from the prompt's logits; token
j >= 1 comes from feeding token j - 1 at context s + j.
"""


def _per_token(model: dict) -> int:
    D, F, L = model["d_model"], model["d_ff"], model["n_layers"]
    H = model["n_heads"] * model["d_head"]
    Hkv = model["n_kv_heads"] * model["d_head"]
    return 2 * L * (D * H + 2 * D * Hkv + H * D + 2 * D * F)


def _attn(model: dict) -> int:
    return 4 * model["n_layers"] * model["n_heads"] * model["d_head"]


def _logits(model: dict) -> int:
    return 2 * model["d_model"] * model["vocab"]


def prompt_flops(model: dict, s: int) -> int:
    return s * _per_token(model) + _attn(model) * s * (s + 1) // 2 \
        + _logits(model)


def tokens_flops(model: dict, s: int, j0: int, j1: int) -> int:
    """Generated tokens j0 .. j1 - 1 of a prompt of s: token 0 comes from
    the prompt's logits; token j >= 1 is the feed of token j - 1 at
    context s + j."""
    fed = [j for j in range(max(1, j0), j1)]
    return len(fed) * (_per_token(model) + _logits(model)) \
        + _attn(model) * sum(s + j for j in fed)


def decode_flops(model: dict, s: int, n: int) -> int:
    return tokens_flops(model, s, 0, n)


def request_flops(model: dict, s: int, n: int) -> int:
    return prompt_flops(model, s) + decode_flops(model, s, n)
