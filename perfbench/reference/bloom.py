"""The architecture of the BLOOM cells: the configuration mapping, the
weights, the float32 reference and the model FLOPs.

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

What the harness takes from this module (``perfbench/run.py``,
"Adding"):

- ``file_sizes(model)``, ``program_sizes(cfg)``: the sizes compared
  between the configuration file's "model" block and the program's
  configuration; ``scaled_program(cfg, model)``: the program's
  configuration cut to the file's sizes (the CPU tests' reduced runs);
- ``make_params(model, seed, device)``: the raw weight tree;
- ``forward_rows(params, model, s_max, rows, device)``: the reference's
  logits at every served position, each row at its own precision;
- ``prompt_flops(model, s)``, ``tokens_flops(model, s, j0, j1)``: the
  model FLOPs of served tokens (``step_mfu``).

**Weights.**  The tree has the serving program's layout (``embed`` (V,
D), ``layers`` [{"attn": {wq, wk, wv, wo}, "norm1", "norm2", "ffn":
{w1, w2}}], ``final_norm``), in the type it is served in.  Each kind of
weight is drawn for all layers in one call, from one ``torch.Generator``
on the device seeded with ``--seed``, and the layers take views of it.
Matmul weights are N(0, 1/fan_in), the embedding table N(0, 0.02^2)
and the norm weights 1 + N(0, 0.1^2), so that the norm's scale is
exercised too.

**Precision.**  The reference derives the served precision itself from
the raw tree, row by row: a row's ``bits`` is the precision spec its
call was served at, as the program writes it (an int: weight bits, 0
for full precision; a pair: (weight bits, activation bits), W8A8 as (8,
8)).  Every matmul weight, the embedding table included, is quantized
per output channel (symmetric, round to nearest even, scale = max|w| /
qmax over the reduction axis -2) and dequantized in float32.  A row
served with int8 activations also has each matmul's input quantized
per row as the program quantizes it (``fake_quant_rows``); the
unembedding reads the dequantized table with float activations, as the
program's does.

**Layout.**  The serving layout is reproduced row by row from the raw
prompt: its last ``s_max`` tokens, padded on the left with token 0 to
``s_max`` positions (``pad_left``), then ``gap`` key slots whose keys
and values are zero (a row admitted into a running cohort at step
``gap``), then the decoded tokens at positions ``s_max + gap + j``.

**FLOPs** of served tokens: the work a served request needs, not what
the padded batch computes.  A token at context c (the keys it attends,
itself included) costs

    2 L (D H + 2 D Hkv + H D + 2 D F)    (the layers' matmuls)
    + 4 L nh dh c                        (q.k and p.v)

and a token whose logits are read adds 2 D V (the tied unembedding).  A
prompt of s tokens reads one row of logits and attends causally, so c
runs 1..s.  Generated token 0 comes from the prompt's logits; token
j >= 1 comes from feeding token j - 1 at context s + j.

Everything runs in float32 with TF32 off.  The module imports nothing
but torch.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
              "d_ff", "vocab", "norm", "act", "tie_embeddings", "rope_theta",
              "dtype")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
# float32(1/127), held exactly by a Python float: the program's activation
# scale is absmax times it, a multiply and not a divide
INV_INT8_MAX = float(torch.tensor(1 / 127, dtype=torch.float32))


# -- the configuration --------------------------------------------------------

def file_sizes(model: Dict) -> Dict:
    """The sizes of the configuration file's "model" block that the
    program's configuration has to hold."""
    return {k: model[k] for k in MODEL_KEYS}


def program_sizes(cfg) -> Dict:
    """The same sizes, read from the program's configuration."""
    return {k: getattr(cfg, k) for k in MODEL_KEYS}


def scaled_program(cfg, model: Dict):
    """The program's configuration cut to the file's sizes."""
    return cfg.scaled(**file_sizes(model))


# -- the weights --------------------------------------------------------------

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


# -- the reference ------------------------------------------------------------

def _precision(bits) -> Tuple[int, int]:
    """(weight bits, activation bits) of a precision spec: an int is
    weight bits with activations in the model's type (16), a pair is
    both."""
    if isinstance(bits, (tuple, list)):
        return int(bits[0]), int(bits[1])
    return int(bits), 16


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
    """``w`` quantized per output channel to ``bits`` (8, 4, or 2: the
    control's step below int4) and dequantized, in float32; ``bits=0``
    keeps it as it is (in float32)."""
    wf = w.to(torch.float32)
    if not bits:
        return wf
    qmax = {8: 127.0, 4: 7.0, 2: 1.0}[bits]
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


def fake_quant_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` quantized per row (over its last axis) to int8 and
    dequantized, in float32, as the program quantizes a matmul's input
    at W8A8 (``quant/ptq.py:quantize_rowwise``): scale = absmax *
    float32(1/127) (1 for a row of zeros), round half to even, clamp to
    [-128, 127]."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax * INV_INT8_MAX,
                        torch.ones_like(absmax))
    return torch.clamp(torch.round(x / scale), -128.0, 127.0) * scale


def _matmul(act_bits: int):
    """``x @ w`` with ``x`` at ``act_bits`` (8: quantized per row)."""
    if act_bits == 8:
        return lambda x, w: fake_quant_rows(x) @ w
    return lambda x, w: x @ w


@torch.no_grad()
def forward_rows(params: Dict, model: Dict, s_max: int,
                 rows: Sequence[Dict], device=None) -> List[torch.Tensor]:
    """Logits (float32) of each row at every position that chose a served
    token: the last prompt position, then each fed token's position.

    A row is {"prompt": ints (the raw prompt, padded here), "gap": int,
    "fed": (n,) ints (the served tokens but the last), "bits": the
    precision spec it was served at}.  Runs layer by layer over all
    rows, so that one layer's float32 weights are held at a time (one
    copy for each weight precision among the rows)."""
    device = device or params["embed"].device
    nh, dh = model["n_heads"], model["d_head"]
    theta = float(model["rope_theta"])
    s_max = int(s_max)
    specs = [_precision(r["bits"]) for r in rows]
    wbits = sorted({w for w, _ in specs})
    with full_float32():
        tables = {b: fake_quant(params["embed"], b) for b in wbits}
        lay, xs = [], []
        for r, (wb, _) in zip(rows, specs):
            prompt = pad_left(r["prompt"], s_max).to(device)
            fed = torch.as_tensor(r["fed"], dtype=torch.long, device=device)
            lay.append(_row_layout(s_max, int(r["gap"]), fed.shape[0],
                                   device))
            xs.append(tables[wb][torch.cat([prompt, fed])])
        for lp in params["layers"]:
            ws = {b: {k: fake_quant(v, b) for k, v in lp["attn"].items()}
                  for b in wbits}
            for i, (tpos, kpos, is_tok) in enumerate(lay):
                w, mm = ws[specs[i][0]], _matmul(specs[i][1])
                x = xs[i]
                T = x.shape[0]
                h = layer_norm(x, lp["norm1"])
                q = rope(mm(h, w["wq"]).reshape(T, nh, dh), tpos, theta)
                k = rope(mm(h, w["wk"]).reshape(T, nh, dh), tpos, theta)
                v = mm(h, w["wv"]).reshape(T, nh, dh)
                kf = k.new_zeros((len(kpos), nh, dh))
                vf = v.new_zeros((len(kpos), nh, dh))
                kf[is_tok], vf[is_tok] = k, v
                logits = torch.einsum("qhd,khd->hqk", q, kf) / math.sqrt(dh)
                mask = kpos[None, :] <= tpos[:, None]
                logits = logits.masked_fill(~mask[None], float("-inf"))
                att = torch.einsum("hqk,khd->qhd", torch.softmax(logits, -1),
                                   vf).reshape(T, nh * dh)
                xs[i] = x + mm(att, w["wo"])
            del ws
            ffn = {b: (fake_quant(lp["ffn"]["w1"], b),
                       fake_quant(lp["ffn"]["w2"], b)) for b in wbits}
            for i in range(len(xs)):
                (w1, w2), mm = ffn[specs[i][0]], _matmul(specs[i][1])
                h = layer_norm(xs[i], lp["norm2"])
                xs[i] = xs[i] + mm(F.gelu(mm(h, w1), approximate="tanh"), w2)
            del ffn
        out = []
        for x, (wb, _) in zip(xs, specs):
            sel = x[s_max - 1:]                  # last prompt + fed tokens
            h = layer_norm(sel, params["final_norm"])
            out.append((h @ tables[wb].T)[:, :model["vocab"]])
        return out


# -- the model FLOPs ----------------------------------------------------------

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
