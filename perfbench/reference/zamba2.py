"""The architecture of the Zamba2-7B-Instruct cell: the configuration
mapping, the weights, the float32 reference and the model FLOPs.

The served model is Zamba2's published block (Zyphra/Zamba2-7B-Instruct
``config.json``; ``transformers``' ``modeling_zamba2.py``).  With e the
token's embedding, x <- e, then for each of the L Mamba2 layers j:

    u  = x + t_i  where j = sites[i] (site i's output), else u = x
    x  = x + Mamba2(RMSNorm(u))

and logits = RMSNorm(x) E^T against the tied embedding table E.  RMSNorm
scales by a weight, eps 1e-5.  The Mamba2 mixer of a (T, D) input h:

    z | xBC | dt = h W_in                    d_inner | d_inner + 2 G N | H
    xBC = silu(causal_conv_K(xBC) + b)       depthwise, width K, bias b
    x | B | C = xBC                          B, C in G groups of N; heads
                                             [g H/G, (g+1) H/G) read group g
    dt  = softplus(dt + dt_bias), A = -exp(A_log)   (no clamp on dt)
    S_t = exp(dt_t A) S_{t-1} + (dt_t x_t) B_t^T    per head, S (P, N)
    y_t = S_t C_t + D x_t
    out = W_out (w * RMSNorm_groups(y * silu(z)))   the norm over each of
                                                    G groups of d_inner / G

Site i runs shared block b = i % 2 (two blocks, ABAB), with no residual
inside it:

    h   = RMSNorm(concat(x, e))                     2 D wide
    q, k, v = h W_q, h W_k, h W_v                   nh heads of dh, rotary
                                                    (split halves, theta)
                                                    over all dh dims
    a   = W_o softmax(q k^T (dh / 2)^-1/2, causal) v
    g   = RMSNorm(a)
    u   = g [W_gate | W_up] + (g A_i) B_i           site i's adapter, rank r
    t_i = (W_down (gelu_erf(u_gate) * u_up)) W_i    site i's linear

The reference computes the recurrence step by step (not the chunked
scan), so that it does not share the program's SSD.  Departures from
the published model, as served: ``tie_word_embeddings`` is assumed true
(the Hugging Face default; ``config.json`` does not set it); dt is not
clamped, as the published kernel path with ``time_step_limit`` null
(``transformers``' slow path clamps it at ``time_step_min``); attention
sees every position (the program's window, 4096, is
``max_position_embeddings``).

What the harness takes from this module (``perfbench/run.py``,
"Adding"): ``file_sizes``, ``program_sizes``, ``scaled_program``,
``make_params``, ``forward_rows``, ``prompt_flops``, ``tokens_flops``.

**Weights.**  The tree has the serving program's layout
(``models/zamba.py``, "The published layout"): ``embed`` (V, D),
``mamba`` [{"in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
"gate_norm", "out_proj", "norm"}], ``blocks`` [{"attn": {wq, wk, wv,
wo}, "ffn": {w1 (gate), w3 (up), w2 (down)}, "norm1", "norm2"}],
``sites`` [{"lora_a", "lora_b", "linear"}], ``final_norm``, in the type
it is served in, from one ``torch.Generator`` on the device seeded with
``--seed``.  The draw (``DRAW``) is N(0, 1/fan_in) for every matmul
weight but the adapters' second factor (N(0, (0.5/sqrt(r))^2)); the
conv taps N(0, 1/K), its bias N(0, 0.1^2); the embedding N(0, 0.02^2)
(Zamba2's initializer range); the norm weights 1 + N(0, 0.1^2), so that
their scale is exercised; as Zamba2 initialises them, dt_bias the
inverse softplus of a dt drawn log-uniform in [0.001, 0.1], A_log =
log(1 .. H) and D = 1.  The embedding's scale decides whether the
served text depends on the prompt: with tied embeddings at unit scale
the current token's own row dominates the logits and a row repeats one
token (on a reduced 81-layer model, d_model 1024, on the CPU: 7 to 11
distinct tokens in 24); at 0.02, 23 or 24 in 24 and no two rows alike.

**Precision.**  A row's ``bits`` is the precision spec its call was
served at.  The hybrid family serves its quantized trees dequantized at
load, with float activations, on every device (``serving/engine.py``):
so at weight bits w the leaves that ``quant/ptq.py:quantize_tree``
quantizes (those named wq, wk, wv, wo, w1, w2, w3, embed: the shared
blocks' projections and the embedding table) are quantized per output
channel and dequantized here, and every other leaf is used as drawn;
the activation bits of a (w, 8) spec change nothing (the program's W8A8
tree is its W8A16 one).

**Layout.**  A row's positions are its raw prompt padded on the left
with token 0 to ``s_max`` (``pad_left``), then the fed tokens.  A row
admitted into a running cohort (``gap`` > 0) raises
``NotImplementedError``: no cell serves this model continuously.

**FLOPs** of served tokens: per token and layer the Mamba2 projections
(2 D (2 d_inner + 2 G N + H) + 2 d_inner D) and the recurrence (4 H P N:
the state's update and read), at each site the projections from 2 D,
o_proj, the GeGLU, the adapter and the linear, and 4 nh dh c for q.k and
p.v at context c; a token whose logits are read adds 2 D V.

Everything runs in float32 with TF32 off.  The module imports nothing
but torch.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
              "d_ff", "vocab", "norm", "act", "tie_embeddings", "rope_theta",
              "dtype")
SSM_KEYS = ("d_state", "head_dim", "expand", "chunk", "conv_width",
            "n_groups", "conv_bias")
HYBRID_KEYS = ("sites", "adapter_rank")
# the shared blocks, used in turn (ABAB)
BLOCKS = 2
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
# the leaves the program quantizes (quant/ptq.py MATMUL_KEYS met in this
# tree)
QUANTIZED = frozenset({"wq", "wk", "wv", "wo", "w1", "w2", "w3", "embed"})
EPS = 1e-5
# the draw's scales (module docstring)
DRAW = dict(embed=0.02, norm=0.1, conv_b=0.1, lora_b=0.5, dt_min=0.001,
            dt_max=0.1)


# -- the configuration --------------------------------------------------------

def file_sizes(model: Dict) -> Dict:
    """The sizes of the configuration file's "model" block that the
    program's configuration has to hold (lists as tuples)."""
    out = {k: model[k] for k in MODEL_KEYS}
    out.update({"ssm." + k: model["ssm"][k] for k in SSM_KEYS})
    out.update({"hybrid." + k: model["hybrid"][k] for k in HYBRID_KEYS})
    out["hybrid.sites"] = tuple(out["hybrid.sites"])
    return out


def program_sizes(cfg) -> Dict:
    """The same sizes, read from the program's configuration."""
    out = {k: getattr(cfg, k) for k in MODEL_KEYS}
    out.update({"ssm." + k: getattr(cfg.ssm, k) for k in SSM_KEYS})
    out.update({"hybrid." + k: getattr(cfg.hybrid, k) for k in HYBRID_KEYS})
    out["hybrid.sites"] = tuple(out["hybrid.sites"])
    return out


def scaled_program(cfg, model: Dict):
    """The program's configuration cut to the file's sizes."""
    ssm = type(cfg.ssm)(**dict(vars(cfg.ssm), **{
        k: model["ssm"][k] for k in SSM_KEYS}))
    hybrid = type(cfg.hybrid)(**dict(vars(cfg.hybrid), **{
        k: tuple(model["hybrid"][k]) if k == "sites" else model["hybrid"][k]
        for k in HYBRID_KEYS}))
    return cfg.scaled(ssm=ssm, hybrid=hybrid,
                      **{k: model[k] for k in MODEL_KEYS})


def _dims(model: Dict):
    """(D, d_inner, H, P, N, G, K, conv channels)."""
    s = model["ssm"]
    D = model["d_model"]
    d_inner = s["expand"] * D
    P, N, G = s["head_dim"], s["d_state"], s["n_groups"]
    return D, d_inner, d_inner // P, P, N, G, s["conv_width"], \
        d_inner + 2 * G * N


# -- the weights --------------------------------------------------------------

def make_params(model: Dict, seed: int, device) -> Dict:
    """The raw weight tree of ``model`` (the configuration file's "model"
    block) from ``seed``, on ``device``."""
    L, F_ = model["n_layers"], model["d_ff"]
    D, d_inner, H, P, N, G, K, C = _dims(model)
    hy = model["hybrid"]
    d_in = 2 * D                                  # concat(x, e)
    nh, nkv, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    r, V = hy["adapter_rank"], model["vocab"]
    dt = DTYPES[model["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))

    def draw(shape, std, mean=0.0):
        x = torch.randn(shape, generator=gen, device=device, dtype=dt)
        x.mul_(std)
        if mean:
            x.add_(mean)
        return x

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32)
        return lo + (hi - lo) * u

    def fan_in(shape):
        return draw(shape, 1 / math.sqrt(shape[-2]))

    in_proj = fan_in((L, D, d_inner + C + H))
    conv_w = draw((L, K, C), 1 / math.sqrt(K))
    conv_b = draw((L, C), DRAW["conv_b"])
    out_proj = fan_in((L, d_inner, D))
    dt0 = torch.exp(uniform((L, H), math.log(DRAW["dt_min"]),
                            math.log(DRAW["dt_max"])))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))        # softplus^-1
    A_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                   device=device)).expand(L, H)
    Dskip = torch.ones((L, H), dtype=torch.float32, device=device)
    gate_norm = draw((L, d_inner), DRAW["norm"], 1.0)
    norms = draw((L + 1, D), DRAW["norm"], 1.0)
    mamba = [{"in_proj": in_proj[j], "conv_w": conv_w[j],
              "conv_b": conv_b[j], "A_log": A_log[j], "D": Dskip[j],
              "dt_bias": dt_bias[j], "gate_norm": gate_norm[j],
              "out_proj": out_proj[j], "norm": norms[j]}
             for j in range(L)]
    blocks = [{"attn": {"wq": fan_in((d_in, nh * dh)),
                        "wk": fan_in((d_in, nkv * dh)),
                        "wv": fan_in((d_in, nkv * dh)),
                        "wo": fan_in((nh * dh, D))},
               "ffn": {"w1": fan_in((D, F_)), "w3": fan_in((D, F_)),
                       "w2": fan_in((F_, D))},
               "norm1": draw((d_in,), DRAW["norm"], 1.0),
               "norm2": draw((D,), DRAW["norm"], 1.0)}
              for _ in range(BLOCKS)]
    sites = [{"lora_a": fan_in((D, r)),
              "lora_b": draw((r, 2 * F_), DRAW["lora_b"] / math.sqrt(r)),
              "linear": fan_in((D, D))} for _ in hy["sites"]]
    embed = draw((V, D), DRAW["embed"])
    return {"mamba": mamba, "blocks": blocks, "sites": sites,
            "embed": embed, "final_norm": norms[L]}


# -- the reference ------------------------------------------------------------

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


def _leaf(name: str, w: torch.Tensor, bits: int) -> torch.Tensor:
    """A leaf as the program serves it at weight ``bits``, in float32."""
    return fake_quant(w, bits if name in QUANTIZED else 0)


def _weight_bits(bits) -> int:
    """The weight bits of a precision spec (an int, or a (weight,
    activation) pair whose activation bits the hybrid family does not
    serve)."""
    return int(bits[0] if isinstance(bits, (tuple, list)) else bits)


def rms_norm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) \
        * w.to(torch.float32)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (R, T, H, dh), pos (T,): split halves rotated by pos * freqs."""
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


def mamba_layer(model: Dict, lp: Dict, u: torch.Tensor) -> torch.Tensor:
    """The Mamba2 mixer of RMSNorm(u), u (R, T, D) float32, by the
    step-by-step recurrence."""
    D, d_inner, H, P, N, G, K, C = _dims(model)
    R, T, _ = u.shape
    f32 = torch.float32
    h = rms_norm(u, lp["norm"])
    z, xBC, dt = torch.split(h @ lp["in_proj"].to(f32), [d_inner, C, H], -1)
    xpad = F.pad(xBC, (0, 0, K - 1, 0))
    w = lp["conv_w"].to(f32)
    conv = sum(xpad[:, k:k + T] * w[k] for k in range(K))
    xBC = F.silu(conv + lp["conv_b"].to(f32))
    x, Bm, Cm = torch.split(xBC, [d_inner, G * N, G * N], -1)
    x = x.reshape(R, T, H, P)
    Bh = Bm.reshape(R, T, G, N).repeat_interleave(H // G, dim=2)
    Ch = Cm.reshape(R, T, G, N).repeat_interleave(H // G, dim=2)
    dt = F.softplus(dt + lp["dt_bias"].to(f32))                  # (R,T,H)
    A = -torch.exp(lp["A_log"].to(f32))
    decay = torch.exp(dt * A)
    xdt = x * dt[..., None]
    S = torch.zeros((R, H, P, N), dtype=f32, device=u.device)
    ys = []
    for t in range(T):
        S = S * decay[:, t, :, None, None] \
            + xdt[:, t, :, :, None] * Bh[:, t, :, None, :]
        ys.append((S * Ch[:, t, :, None, :]).sum(-1))
    y = torch.stack(ys, 1) + x * lp["D"].to(f32)[:, None]
    g = (y.reshape(R, T, d_inner) * F.silu(z)).reshape(R, T, G, -1)
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + EPS)
    g = g.reshape(R, T, d_inner) * lp["gate_norm"].to(f32)
    return g @ lp["out_proj"].to(f32)


def site(model: Dict, bp: Dict, sp: Dict, x: torch.Tensor,
         e: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """A site's output t_i over (R, T, D) float32 x and embeddings e; the
    block's leaves ``bp`` are already at the row's precision."""
    nh, nkv, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    R, T, _ = x.shape
    theta = float(model["rope_theta"])
    h = rms_norm(torch.cat([x, e], -1), bp["norm1"])
    a = bp["attn"]
    q = rope((h @ a["wq"]).reshape(R, T, nh, dh), pos, theta)
    k = rope((h @ a["wk"]).reshape(R, T, nkv, dh), pos, theta)
    v = (h @ a["wv"]).reshape(R, T, nkv, dh)
    k = k.repeat_interleave(nh // nkv, dim=2)
    v = v.repeat_interleave(nh // nkv, dim=2)
    logits = torch.einsum("rqhd,rkhd->rhqk", q, k) * (dh / 2) ** -0.5
    mask = pos[None, :] <= pos[:, None]
    logits = logits.masked_fill(~mask, float("-inf"))
    att = torch.einsum("rhqk,rkhd->rqhd", torch.softmax(logits, -1), v)
    g = rms_norm(att.reshape(R, T, nh * dh) @ a["wo"], bp["norm2"])
    f = bp["ffn"]
    dg, du = torch.chunk((g @ sp["lora_a"].float()) @ sp["lora_b"].float(),
                         2, -1)
    gate, up = g @ f["w1"] + dg, g @ f["w3"] + du
    m = (F.gelu(gate) * up) @ f["w2"]
    return m @ sp["linear"].float()


def _block_at(bp: Dict, bits: int) -> Dict:
    return {"attn": {k: _leaf(k, v, bits) for k, v in bp["attn"].items()},
            "ffn": {k: _leaf(k, v, bits) for k, v in bp["ffn"].items()},
            "norm1": bp["norm1"], "norm2": bp["norm2"]}


@torch.no_grad()
def forward_rows(params: Dict, model: Dict, s_max: int,
                 rows: Sequence[Dict], device=None) -> List[torch.Tensor]:
    """Logits (float32) of each row at every position that chose a served
    token: the last prompt position, then each fed token's position.

    A row is {"prompt": ints (the raw prompt, padded here), "gap": int,
    "fed": (n,) ints (the served tokens but the last), "bits": the
    precision spec it was served at}.  Rows of one weight precision run
    together, padded at their end to the longest (the recurrence and the
    causal attention never look ahead); layer by layer, so that one
    layer's float32 weights are held at a time."""
    device = device or params["embed"].device
    s_max = int(s_max)
    if any(int(r["gap"]) for r in rows):
        raise NotImplementedError("a row admitted into a running cohort "
                                  "(gap > 0): no continuous Zamba2 cell")
    sites = {j: i for i, j in enumerate(model["hybrid"]["sites"])}
    out: List[torch.Tensor] = [None] * len(rows)
    with full_float32():
        for wb in sorted({_weight_bits(r["bits"]) for r in rows}):
            idx = [i for i, r in enumerate(rows)
                   if _weight_bits(r["bits"]) == wb]
            toks = [torch.cat([pad_left(rows[i]["prompt"], s_max),
                               torch.as_tensor(rows[i]["fed"],
                                               dtype=torch.long).reshape(-1)])
                    for i in idx]
            T = max(len(t) for t in toks)
            ids = torch.zeros((len(idx), T), dtype=torch.long)
            for n, t in enumerate(toks):
                ids[n, :len(t)] = t
            table = _leaf("embed", params["embed"], wb)
            e = table[ids.to(device)]
            pos = torch.arange(T, device=device)
            blocks = params["blocks"]
            x = e
            for j, lp in enumerate(params["mamba"]):
                u = x
                if j in sites:
                    i = sites[j]
                    bp = _block_at(blocks[i % len(blocks)], wb)
                    u = x + site(model, bp, params["sites"][i], x, e, pos)
                    del bp
                x = x + mamba_layer(model, lp, u)
            x = rms_norm(x, params["final_norm"])
            for n, i in enumerate(idx):
                sel = x[n, s_max - 1:len(toks[n])]
                out[i] = (sel @ table.T)[:, :model["vocab"]]
    return out


# -- the model FLOPs ----------------------------------------------------------

def _per_token(model: Dict) -> int:
    """Matmul and recurrence FLOPs of one token, all layers and sites."""
    D, d_inner, H, P, N, G, K, C = _dims(model)
    hy = model["hybrid"]
    nh, nkv, dh, F_ = (model["n_heads"], model["n_kv_heads"],
                       model["d_head"], model["d_ff"])
    mamba = 2 * D * (d_inner + C + H) + 2 * d_inner * D + 4 * H * P * N
    per_site = (2 * 2 * D * (nh + 2 * nkv) * dh + 2 * nh * dh * D
                + 6 * D * F_ + 2 * hy["adapter_rank"] * (D + 2 * F_)
                + 2 * D * D)
    return model["n_layers"] * mamba + len(hy["sites"]) * per_site


def _attn(model: Dict) -> int:
    return 4 * len(model["hybrid"]["sites"]) * model["n_heads"] \
        * model["d_head"]


def _logits(model: Dict) -> int:
    return 2 * model["d_model"] * model["vocab"]


def prompt_flops(model: Dict, s: int) -> int:
    return s * _per_token(model) + _attn(model) * s * (s + 1) // 2 \
        + _logits(model)


def tokens_flops(model: Dict, s: int, j0: int, j1: int) -> int:
    """Generated tokens j0 .. j1 - 1 of a prompt of s: token 0 comes from
    the prompt's logits; token j >= 1 is the feed of token j - 1 at
    context s + j."""
    fed = [j for j in range(max(1, j0), j1)]
    return len(fed) * (_per_token(model) + _logits(model)) \
        + _attn(model) * sum(s + j for j in fed)
