"""Weights of a cell, drawn from the seed on the device.

The tree has the serving program's layout for its dense decoder
(``embed`` (V, D), ``layers`` [{"attn": {wq, wk, wv, wo}, "norm1",
"norm2", "ffn": {w1, w2}}], ``final_norm``), in the type it is served in.
Each kind of weight is drawn for all layers in one call, from one
``torch.Generator`` on the device seeded with ``--seed``, and the layers
take views of it.  Matmul weights are N(0, 1/fan_in), the embedding
table N(0, 0.02^2) and the norm weights 1 + N(0, 0.1^2), so that the
norm's scale is exercised too.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def make_params(model: Dict, seed: int, device) -> Dict:
    """The raw weight tree of ``model`` (the configuration file's "model"
    block) from ``seed``, on ``device``."""
    L, D, F = model["n_layers"], model["d_model"], model["d_ff"]
    H = model["n_heads"] * model["d_head"]
    Hkv = model["n_kv_heads"] * model["d_head"]
    V = model["vocab"]
    dt = DTYPES[model["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))

    def draw(shape, std, mean=0.0):
        x = torch.randn(shape, generator=gen, device=device, dtype=dt)
        x.mul_(std)
        if mean:
            x.add_(mean)
        return x

    wq = draw((L, D, H), 1 / math.sqrt(D))
    wk = draw((L, D, Hkv), 1 / math.sqrt(D))
    wv = draw((L, D, Hkv), 1 / math.sqrt(D))
    wo = draw((L, H, D), 1 / math.sqrt(H))
    w1 = draw((L, D, F), 1 / math.sqrt(D))
    w2 = draw((L, F, D), 1 / math.sqrt(F))
    norms = draw((2 * L + 1, D), 0.1, 1.0)
    embed = draw((V, D), 0.02)
    layers = [{"attn": {"wq": wq[i], "wk": wk[i], "wv": wv[i], "wo": wo[i]},
               "norm1": norms[2 * i], "norm2": norms[2 * i + 1],
               "ffn": {"w1": w1[i], "w2": w2[i]}} for i in range(L)]
    return {"embed": embed, "layers": layers, "final_norm": norms[2 * L]}
