"""Plain float32 reference of the decoder the BLOOM cells serve.

The served model is a pre-norm decoder at BLOOM's published widths:
token embedding, then per layer ``x += Wo attn(LN1(x))`` and ``x +=
W2 gelu_tanh(W1 LN2(x))``, a final LN and logits against the tied
embedding table.  Layer norms scale by a weight and have no bias; the
matmuls have no bias; attention is causal multi-head attention with
rotary position embeddings (split halves, theta 1e4) and scale
1/sqrt(d_head).  This is the architecture of the served program, which
departs from the published BLOOM (ALiBi, biases, an embedding layer
norm): the reference follows what is served, so that its logits judge
the served tokens.

Weights are given as the raw tree the benchmark drew (``embed`` (V, D),
``layers`` [{"attn": {wq, wk, wv, wo}, "norm1", "norm2", "ffn": {w1,
w2}}], ``final_norm``).  The reference derives the served precision
itself: every matmul weight, the embedding table included, is quantized
per output channel (symmetric, round to nearest even, scale = max|w| /
qmax over the reduction axis -2) and dequantized in float32.

The serving layout is reproduced row by row from the raw prompt: its
last ``s_max`` tokens, padded on the left with token 0 to ``s_max``
positions (``pad_left``), then ``gap`` key slots whose keys and values
are zero (a row admitted into a running cohort at step ``gap``), then
the decoded tokens at positions ``s_max + gap + j``.

Everything runs in float32 with TF32 off.  The module imports nothing
but torch.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2")


@contextlib.contextmanager
def full_float32():
    """TF32 off for matmuls and convolutions, restored on exit."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
        torch.set_float32_matmul_precision(prec)


def fake_quant(w: torch.Tensor, bits: int) -> torch.Tensor:
    """``w`` quantized per output channel to ``bits`` (8 or 4) and
    dequantized, in float32; ``bits=0`` keeps it as it is (in float32)."""
    wf = w.to(torch.float32)
    if not bits:
        return wf
    qmax = {8: 127.0, 4: 7.0}[bits]
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale), -qmax - 1, qmax)
    return q * scale


def layer_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w.to(torch.float32)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, dh), pos (T,): split halves rotated by pos * freqs."""
    dh = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=x.device) / dh)
    ang = pos.to(torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def pad_left(prompt, s_max: int) -> torch.Tensor:
    """The prompt's last ``s_max`` tokens, right-aligned in ``s_max``
    positions with token 0 before them."""
    p = torch.as_tensor(prompt, dtype=torch.long).reshape(-1)[-s_max:]
    out = torch.zeros(s_max, dtype=torch.long)
    out[s_max - p.shape[0]:] = p
    return out


def _row_layout(s_max: int, gap: int, n_fed: int, device):
    """Positions of a row's tokens, and of its keys with the zero slots
    of the gap between the prompt and the decoded tokens."""
    tok = torch.cat([torch.arange(s_max), s_max + gap + torch.arange(n_fed)])
    keys = torch.arange(s_max + gap + n_fed)
    is_tok = torch.ones(len(keys), dtype=torch.bool)
    is_tok[s_max:s_max + gap] = False
    return tok.to(device), keys.to(device), is_tok.to(device)


@torch.no_grad()
def forward_rows(params: Dict, cfg: Dict, rows: Sequence[Dict],
                 bits: int = 8, device=None) -> List[torch.Tensor]:
    """Logits (float32) of each row at every position that chose a served
    token: the last prompt position, then each fed token's position.

    ``cfg``: {"n_heads", "d_head", "vocab", "rope_theta", "s_max"}.  A
    row is {"prompt": ints (the raw prompt, padded here), "gap": int,
    "fed": (n,) ints (the served tokens but the last)}.  Runs layer by layer over all rows, so
    that one layer's float32 weights are held at a time."""
    device = device or params["embed"].device
    nh, dh = cfg["n_heads"], cfg["d_head"]
    theta = float(cfg.get("rope_theta", 1e4))
    s_max = int(cfg["s_max"])
    with full_float32():
        table = fake_quant(params["embed"], bits)
        lay, xs = [], []
        for r in rows:
            prompt = pad_left(r["prompt"], s_max).to(device)
            fed = torch.as_tensor(r["fed"], dtype=torch.long, device=device)
            lay.append(_row_layout(s_max, int(r["gap"]), fed.shape[0],
                                   device))
            xs.append(table[torch.cat([prompt, fed])])
        for lp in params["layers"]:
            w = {k: fake_quant(v, bits) for k, v in lp["attn"].items()}
            for i, (tpos, kpos, is_tok) in enumerate(lay):
                x = xs[i]
                T = x.shape[0]
                h = layer_norm(x, lp["norm1"])
                q = rope((h @ w["wq"]).reshape(T, nh, dh), tpos, theta)
                k = rope((h @ w["wk"]).reshape(T, nh, dh), tpos, theta)
                v = (h @ w["wv"]).reshape(T, nh, dh)
                kf = k.new_zeros((len(kpos), nh, dh))
                vf = v.new_zeros((len(kpos), nh, dh))
                kf[is_tok], vf[is_tok] = k, v
                logits = torch.einsum("qhd,khd->hqk", q, kf) / math.sqrt(dh)
                mask = kpos[None, :] <= tpos[:, None]
                logits = logits.masked_fill(~mask[None], float("-inf"))
                att = torch.einsum("hqk,khd->qhd", torch.softmax(logits, -1),
                                   vf).reshape(T, nh * dh)
                xs[i] = x + att @ w["wo"]
            del w
            w1 = fake_quant(lp["ffn"]["w1"], bits)
            w2 = fake_quant(lp["ffn"]["w2"], bits)
            for i in range(len(xs)):
                h = layer_norm(xs[i], lp["norm2"])
                xs[i] = xs[i] + F.gelu(h @ w1, approximate="tanh") @ w2
            del w1, w2
        out = []
        for x in xs:
            sel = x[s_max - 1:]                  # last prompt + fed tokens
            h = layer_norm(sel, params["final_norm"])
            out.append((h @ table.T)[:, :cfg["vocab"]])
        return out
