"""xLSTM, sLSTM + mLSTM blocks, arXiv:2405.04517 (port of
``repro.models.xlstm``).

* mLSTM: matrix-memory linear attention with exponential input gates and
  sigmoid forget gates.  Prefill runs the CHUNKWISE stabilized form
  (``mlstm_chunked``: quadratic products inside a chunk of 128, a short
  loop carrying (C_hat, n_hat, m) across chunks); ``mlstm_reference`` is
  the step-by-step oracle, and a decode step is one step of it.
* sLSTM: scalar-memory recurrent cell with per-head block-diagonal
  recurrent weights, a loop over time; ``h`` is carried in the model dtype.
* Layout: every ``slstm_every``-th block is an sLSTM block: G groups of
  (slstm_every - 1) mLSTM + 1 sLSTM, then any tail of mLSTM blocks.

The mLSTM q, k and v are full d_in x d_in projections, as in the JAX
package's config (the paper's are block-diagonal): xlstm-1.3b builds
3.65 B parameters.

Params: ``embed``, ``mlstm`` (G * M layer dicts, group-major; the JAX
package stacks them (G, M, ...)), ``slstm`` (G dicts), ``tail``,
``final_norm``, ``lm_head``.  Cache: a list in execution order, batch on
axis 0 of every leaf: each group's M mLSTM states {"C" (B, nh, dh, dh),
"n" (B, nh, dh), "m" (B, nh) float32, "conv" (B, K-1, d_in)}, then its
sLSTM state {"c", "n" (B, nh, dh) float32, "h" (B, nh, dh) model dtype,
"m" (B, nh) float32}; then the tail's mLSTM states.  ``decode_step``
writes the new states in place (``copy_``).  The decode state is
O(1) in the context length; no kernel serves this family, as in the JAX
package.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import common
from repro_torch.models.mamba2 import _causal_conv
from repro_torch.utils.remat import maybe_remat, remat_enabled
from repro_torch.utils.sharding import (axis_divisor, constrain, head_local,
                                        local_elementwise)

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]

NEG = -1e30
MLSTM_CHUNK = 128
SLSTM_STATE = ("c", "n", "h", "m")


def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_in = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
    nh = cfg.n_heads
    return d_in, nh, d_in // nh


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def init_mlstm(cfg: ModelConfig, gen: torch.Generator, dt) -> Params:
    dm = cfg.d_model
    d_in, nh, dh = _mlstm_dims(cfg)
    dev = gen.device
    return {
        "norm": common.make_norm_params(cfg, dt, dev),
        "w_up": common.dense_init(gen, (dm, 2 * d_in), 0, dt),
        "conv_w": common.dense_init(gen, (cfg.xlstm.conv_width, d_in), 0, dt),
        "wq": common.dense_init(gen, (d_in, d_in), 0, dt),
        "wk": common.dense_init(gen, (d_in, d_in), 0, dt),
        "wv": common.dense_init(gen, (d_in, d_in), 0, dt),
        "wi": common.dense_init(gen, (d_in, nh), 0, dt),
        "wf": common.dense_init(gen, (d_in, nh), 0, dt),
        "bi": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "bf": torch.full((nh,), 3.0, dtype=torch.float32, device=dev),
        "gn": torch.ones((d_in,), dtype=dt, device=dev),
        "w_down": common.dense_init(gen, (d_in, dm), 0, dt),
    }


def _mlstm_qkvif(cfg: ModelConfig, p: Params, x_norm: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Project inputs.  x_norm: (B, T, dm).  Returns q, k, v (B, T, nh,
    dh), ilog/flog (B, T, nh) float32, z (B, T, d_in), the new conv
    state."""
    d_in, nh, dh = _mlstm_dims(cfg)
    B, T, _ = x_norm.shape
    x_in, z = torch.chunk(x_norm @ p["w_up"], 2, dim=-1)
    x_c, conv_state = _causal_conv(p["conv_w"], x_in, conv_state)
    q = common.split_heads(x_c @ p["wq"], nh, dh) * (1.0 / math.sqrt(dh))
    k = common.split_heads(x_c @ p["wk"], nh, dh)
    v = common.split_heads(x_in @ p["wv"], nh, dh)
    ilog = (x_c @ p["wi"]).to(torch.float32) + p["bi"]
    flog = local_elementwise(F.logsigmoid,
                             (x_c @ p["wf"]).to(torch.float32) + p["bf"])
    return q, k, v, ilog, flog, z, conv_state


def _zero_mlstm_state(B, nh, dh, device):
    f32 = torch.float32
    return {"C": torch.zeros((B, nh, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((B, nh, dh), dtype=f32, device=device),
            "m": torch.full((B, nh), NEG, dtype=f32, device=device)}


def mlstm_chunked(q, k, v, ilog, flog, chunk: int, state=None):
    """Chunkwise stabilized mLSTM.

    q, k, v: (B, T, nh, dh); ilog/flog: (B, T, nh).  ``state``: {"C" (B,
    nh, dh, dh), "n" (B, nh, dh), "m" (B, nh)} (stabilized: the true C is
    C_hat * exp(m)).  Returns (h (B, T, nh, dh) in q's dtype, the new
    state).  A T that is not a multiple of the chunk is padded with steps
    of input gate NEG and forget gate 1 (log 0), which leave the state as
    it was; their outputs are cut off."""
    B, T, nh, dh = q.shape
    Q = min(chunk, T)
    T0 = T
    if T % Q:
        pad = Q - T % Q
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        ilog = F.pad(ilog, (0, 0, 0, pad), value=NEG)
        flog = F.pad(flog, (0, 0, 0, pad))
        T = T + pad
    nc = T // Q
    f32 = torch.float32

    def rs(a):  # (B, T, nh, ...) -> (B, nc, nh, Q, ...)
        return a.reshape((B, nc, Q) + tuple(a.shape[2:])).transpose(2, 3)

    qc, kc, vc = rs(q).to(f32), rs(k).to(f32), rs(v).to(f32)
    ic, fc = rs(ilog), rs(flog)                       # (B, nc, nh, Q)
    b = torch.cumsum(fc, dim=-1)                      # inclusive in the chunk
    Fs = b[..., -1]                                   # (B, nc, nh)
    # intra-chunk decay matrix D[l, s] = b_l - b_s + i_s (s <= l)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    D = torch.where(tri, b[..., :, None] - b[..., None, :] + ic[..., None, :],
                    torch.full((), NEG, dtype=f32, device=q.device))
    m_intra = torch.amax(D, dim=-1)                   # (B, nc, nh, Q)
    w_state = Fs[..., None] - b + ic                  # (B, nc, nh, Q)
    m_state_intra = torch.amax(w_state, dim=-1)       # (B, nc, nh)

    if state is None:
        state = _zero_mlstm_state(B, nh, dh, q.device)
    C, n, m = state["C"], state["n"], state["m"]
    # chunk-major reads with the chunk axis replicated: the residual
    # arrives sequence-sharded over 'model', and a sharded chunk axis
    # would cost a resharding collective per chunk per layer
    qc, kc, vc, D, m_intra, b, ic, Fs, w_state, m_state_intra = (
        constrain(a, "batch", *([None] * (a.ndim - 1)))
        for a in (qc, kc, vc, D, m_intra, b, ic, Fs, w_state, m_state_intra))
    shard_c = remat_enabled()
    hs = []
    for c in range(nc):
        qx, kx, vx = qc[:, c], kc[:, c], vc[:, c]
        m_inter = b[:, c] + m[:, :, None]             # (B, nh, Q)
        m_out = torch.maximum(m_intra[:, c], m_inter)
        w = torch.exp(D[:, c] - m_out[..., None])     # (B, nh, Q, Q)
        scores = torch.einsum("bhld,bhsd->bhls", qx, kx) * w
        num = torch.einsum("bhls,bhsd->bhld", scores, vx)
        den = torch.sum(scores, dim=-1)               # (B, nh, Q)
        scale_inter = torch.exp(m_inter - m_out)[..., None]
        num = num + torch.einsum("bhld,bhde->bhle", qx, C) * scale_inter
        den = den + torch.einsum("bhld,bhd->bhl", qx, n) * scale_inter[..., 0]
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_out))[..., None])
        # state update
        m_next = torch.maximum(m + Fs[:, c], m_state_intra[:, c])
        wsn = torch.exp(w_state[:, c] - m_next[..., None])   # (B, nh, Q)
        decay = torch.exp(m + Fs[:, c] - m_next)
        C = C * decay[..., None, None] \
            + torch.einsum("bhsd,bhse->bhde", wsn[..., None] * kx, vx)
        n = n * decay[..., None] + torch.einsum("bhs,bhsd->bhd", wsn, kx)
        m = m_next
        if shard_c:
            # train only: backward saves every chunk's carry, so C is
            # sharded to keep them in memory; prefill keeps C replicated
            C = constrain(C, "batch", None, "model", None)
    h = torch.stack(hs, dim=1)                        # (B, nc, nh, Q, dh)
    h = h.transpose(2, 3).reshape(B, T, nh, dh)[:, :T0]
    return h.to(q.dtype), {"C": C, "n": n, "m": m}


def _mlstm_step(C, n, m, qt, kt, vt, it, ft):
    """One stabilized mLSTM step on float32 (B, nh[, dh]) inputs: (h, C, n,
    m) after it."""
    m_new = torch.maximum(ft + m, it)
    fs = torch.exp(ft + m - m_new)[..., None]
    is_ = torch.exp(it - m_new)[..., None]
    C = C * fs[..., None] + is_[..., None] * kt[..., :, None] * vt[..., None, :]
    n = n * fs + is_ * kt
    num = torch.einsum("bhd,bhde->bhe", qt, C)
    den = torch.abs(torch.einsum("bhd,bhd->bh", qt, n))
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return h, C, n, m_new


def mlstm_reference(q, k, v, ilog, flog, state=None):
    """Step-by-step recurrence oracle (float32, stabilized)."""
    B, T, nh, dh = q.shape
    if state is None:
        state = _zero_mlstm_state(B, nh, dh, q.device)
    C, n, m = state["C"], state["n"], state["m"]
    f32 = torch.float32
    hs = []
    for t in range(T):
        h, C, n, m = _mlstm_step(C, n, m, q[:, t].to(f32), k[:, t].to(f32),
                                 v[:, t].to(f32), ilog[:, t].to(f32),
                                 flog[:, t].to(f32))
        hs.append(h)
    return torch.stack(hs, dim=1).to(q.dtype), {"C": C, "n": n, "m": m}


def _mlstm_out(cfg, p, x, h, z):
    """x + (rmsnorm(h * silu(z)) @ w_down)."""
    h = common.merge_heads(h)
    h = common.apply_norm("rmsnorm", p["gn"],
                          h * F.silu(z.to(torch.float32)).to(h.dtype))
    return x + constrain(h @ p["w_down"], "batch", None, None)


def mlstm_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                collect_state: bool = False):
    """Full-sequence mLSTM block with its residual: (x', state | None)."""
    h_in = common.apply_norm(cfg.norm, p["norm"], x)
    q, k, v, ilog, flog, z, conv_state = _mlstm_qkvif(cfg, p, h_in)
    h, st = mlstm_chunked(q, k, v, ilog, flog, chunk=MLSTM_CHUNK)
    state = {**st, "conv": conv_state} if collect_state else None
    return common.seq_shard(_mlstm_out(cfg, p, x, h, z)), state


def mlstm_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One token through an mLSTM block (one step of ``mlstm_reference``);
    ``state`` {"C", "n", "m", "conv"} is updated in place.  Returns x' (B,
    1, dm)."""
    h_in = common.apply_norm(cfg.norm, p["norm"], x)
    q, k, v, ilog, flog, z, conv_state = _mlstm_qkvif(cfg, p, h_in,
                                                      state["conv"])
    f32 = torch.float32
    # under a mesh the step runs on each device's batch and head shard
    h, C, n, m = head_local(
        _mlstm_step, (state["C"], state["n"], state["m"], q[:, 0].to(f32),
                      k[:, 0].to(f32), v[:, 0].to(f32), ilog[:, 0],
                      flog[:, 0]), (1,) * 8,
        cfg.n_heads % axis_divisor("model") == 0, out_head_dims=(1,) * 4)
    out = _mlstm_out(cfg, p, x, h[:, None].to(q.dtype), z)
    for name, new in (("C", C), ("n", n), ("m", m), ("conv", conv_state)):
        state[name].copy_(new)
    return out


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------


def init_slstm(cfg: ModelConfig, gen: torch.Generator, dt) -> Params:
    dm = cfg.d_model
    nh = cfg.n_heads
    dh = dm // nh
    d_ff = int(cfg.xlstm.proj_factor_slstm * dm)
    dev = gen.device
    f32 = torch.float32
    return {
        "norm": common.make_norm_params(cfg, dt, dev),
        "w_gates": common.dense_init(gen, (dm, 4 * dm), 0, dt),   # z, i, f, o
        "r_gates": common.dense_init(gen, (4, nh, dh, dh), 2, dt),
        "b_gates": torch.cat([torch.zeros((2 * dm,), dtype=f32),
                              torch.full((dm,), 3.0, dtype=f32),
                              torch.zeros((dm,), dtype=f32)]).to(dev),
        "gn": torch.ones((dm,), dtype=dt, device=dev),
        "norm2": common.make_norm_params(cfg, dt, dev),
        "ffn_w1": common.dense_init(gen, (dm, d_ff), 0, dt),
        "ffn_w3": common.dense_init(gen, (dm, d_ff), 0, dt),
        "ffn_w2": common.dense_init(gen, (d_ff, dm), 0, dt),
    }


def _slstm_cell_step(p: Params, nh: int, dh: int, xw: torch.Tensor, carry):
    """One time step.  xw: (B, 4 dm) pre-projected input contribution;
    carry: (c, n, h, m), each (B, nh, dh) but m (B, nh); h in the model
    dtype, the others float32."""
    c, n, h, m = carry
    B = xw.shape[0]
    # recurrent contribution: h (B, nh, dh) @ r (4, nh, dh, dh)
    rec = torch.einsum("bhd,ghde->gbhe", h, p["r_gates"].to(h.dtype))
    gates = xw.reshape(B, 4, nh, dh).transpose(0, 1) + rec
    gates = gates.to(torch.float32) + p["b_gates"].reshape(4, 1, nh, dh)
    zt = torch.tanh(gates[0])
    it = gates[1]                                    # log-space input gate
    ft = local_elementwise(F.logsigmoid, gates[2])
    ot = torch.sigmoid(gates[3])
    # per-head shared stabilizer (max over the head's dims)
    m_new = torch.maximum(torch.amax(ft, dim=-1) + m, torch.amax(it, dim=-1))
    fs = torch.exp(ft + (m - m_new)[..., None])
    is_ = torch.exp(it - m_new[..., None])
    c = fs * c + is_ * zt
    n = fs * n + is_
    # maximum, not clamp: at n == 1e-6 its gradient splits between the
    # two sides, as the JAX package's jnp.maximum does
    h_new = ot * c / torch.maximum(n, n.new_full((), 1e-6))
    return c, n, h_new.to(h.dtype), m_new


def _slstm_zero_state(cfg, B, dtype, device):
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    f32 = torch.float32
    z = torch.zeros((B, nh, dh), dtype=f32, device=device)
    return (z, z.clone(), z.to(dtype),
            torch.full((B, nh), NEG, dtype=f32, device=device))


def slstm_block(cfg: ModelConfig, p: Params, x: torch.Tensor, state=None):
    """Full-sequence sLSTM block (a loop over time) and its gated FFN:
    (x', the (c, n, h, m) state after the last step)."""
    dm = cfg.d_model
    nh = cfg.n_heads
    dh = dm // nh
    B, T, _ = x.shape
    h_in = common.apply_norm(cfg.norm, p["norm"], x)
    # (B, T, 4 dm); under a mesh gathered whole (the cell splits it into
    # gates and heads, which a model-axis shard would cut across)
    xw = constrain(h_in @ p["w_gates"], "batch", None, None)
    if state is None:
        state = _slstm_zero_state(cfg, B, x.dtype, x.device)
    # the cell's recurrent weights and biases, gathered whole once for the
    # loop under a mesh (FSDP stores them sharded; a step reshapes them
    # into gates and heads)
    cell = {"r_gates": constrain(p["r_gates"], None, None, None, None),
            "b_gates": constrain(p["b_gates"], None)}
    hs = []
    for t in range(T):
        state = _slstm_cell_step(cell, nh, dh, xw[:, t], state)
        hs.append(state[2])
    h = torch.stack(hs, dim=1).reshape(B, T, dm)
    x = x + common.apply_norm("rmsnorm", p["gn"], h)
    # gated FFN sub-block
    h2 = common.apply_norm(cfg.norm, p["norm2"], x)
    ff = constrain(F.silu(h2 @ p["ffn_w1"]) * (h2 @ p["ffn_w3"]),
                   "batch", None, "model")
    ff = constrain(ff @ p["ffn_w2"], "batch", None, None)
    return common.seq_shard(x + ff), state


def slstm_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One token through an sLSTM block; ``state`` {"c", "n", "h", "m"} is
    updated in place."""
    x, new = slstm_block(cfg, p, x, tuple(state[k] for k in SLSTM_STATE))
    for name, val in zip(SLSTM_STATE, new):
        state[name].copy_(val)
    return x


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def _layout(cfg: ModelConfig):
    k = cfg.xlstm.slstm_every
    G = cfg.n_layers // k
    tail = cfg.n_layers - G * k          # tail mLSTM layers
    return G, k - 1, tail                # G groups of (k-1 mLSTM + 1 sLSTM)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random weights from ``gen``, on ``gen.device``."""
    dt = common.torch_dtype(cfg)
    G, M, tail = _layout(cfg)
    Vp = cfg.vocab_padded()
    p = {}
    if G:
        p["mlstm"] = [init_mlstm(cfg, gen, dt) for _ in range(G * M)]
        p["slstm"] = [init_slstm(cfg, gen, dt) for _ in range(G)]
    if tail:
        p["tail"] = [init_mlstm(cfg, gen, dt) for _ in range(tail)]
    p["embed"] = common.embed_init(gen, (Vp, cfg.d_model), dt)
    p["final_norm"] = common.make_norm_params(cfg, dt, gen.device)
    p["lm_head"] = common.dense_init(gen, (cfg.d_model, Vp), 0, dt)
    return p


def _kinds(cfg: ModelConfig) -> List[str]:
    """"m" (mLSTM) or "s" (sLSTM) for every block in execution order."""
    G, M, tail = _layout(cfg)
    return (["m"] * M + ["s"]) * G + ["m"] * tail


def _blocks(cfg: ModelConfig, params: Params):
    """(kind, layer params) of every block in execution order."""
    m = iter(params.get("mlstm", []) + params.get("tail", []))
    s = iter(params.get("slstm", []))
    return [(k, next(m if k == "m" else s)) for k in _kinds(cfg)]


def _run_stack(cfg: ModelConfig, params: Params, x: torch.Tensor,
               on_state=None) -> torch.Tensor:
    """The embedded sequence through every block and the final norm;
    ``on_state(state)`` sees each block's end state, in execution order.
    Without ``on_state`` each block goes through ``maybe_remat``.  The JAX
    package also wraps each group (its mLSTM layers and its sLSTM block)
    around them; the port does not nest checkpoints (a nested non-reentrant
    checkpoint failed its recompute check under PyTorch 2.11 on the card),
    which recomputes the same values."""
    wrap = maybe_remat if on_state is None else (lambda body: body)

    def m_layer(x, lp):
        x, st = mlstm_block(cfg, lp, x, collect_state=on_state is not None)
        if on_state is not None:
            on_state(st)
        return x

    def s_layer(x, lp):
        x, st = slstm_block(cfg, lp, x)
        if on_state is not None:
            on_state(dict(zip(SLSTM_STATE, st)))
        return x

    body = {"m": wrap(m_layer), "s": wrap(s_layer)}
    for kind, lp in _blocks(cfg, params):
        x = body[kind](x, lp)
    return common.apply_norm(cfg.norm, params["final_norm"], x)


def forward(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Logits (B, S, Vp) of the whole sequence."""
    x = constrain(common.embed(params["embed"], batch["tokens"]), "batch", None, None)
    return common.mm(_run_stack(cfg, params, x), params["lm_head"])


def loss_fn(cfg: ModelConfig, params: Params, batch):
    from repro_torch.models.api import cross_entropy
    logits = forward(cfg, params, batch)
    loss = cross_entropy(logits, batch["labels"], cfg.vocab,
                         batch.get("loss_mask"))
    return loss, {"loss": loss}


def prefill(cfg: ModelConfig, params: Params, batch, cache_len: int = 0,
            out: Cache = None):
    """The prompt through the stack: (last-token logits, cache);
    ``cache_len`` does not apply (the state is O(1) in the context);
    ``out``: a cache to fill in place and return."""
    cache: Cache = []

    def keep(st):
        if out is not None:
            dst = out[len(cache)]
            for name, val in st.items():
                dst[name].copy_(val)
            st = dst
        cache.append(st)

    x = constrain(common.embed(params["embed"], batch["tokens"]), "batch", None, None)
    x = _run_stack(cfg, params, x, keep)
    return common.mm(x[:, -1:], params["lm_head"])[:, 0], cache


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                tokens: torch.Tensor, pos=None):
    """One decode iteration (``pos`` does not apply: no block reads a
    position).  Updates ``cache`` in place; returns (logits (B, Vp),
    cache)."""
    x = constrain(common.embed(params["embed"], tokens), "batch", None, None)
    for (kind, lp), st in zip(_blocks(cfg, params), cache):
        if kind == "m":
            x = mlstm_decode(cfg, lp, x, st)
        else:
            x = slstm_decode(cfg, lp, x, st)
    x = common.apply_norm(cfg.norm, params["final_norm"], x)
    return common.mm(x, params["lm_head"])[:, 0], cache


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device) -> Cache:
    """Zero states (``cache_len`` is ignored: the state is O(1) in the
    context); m starts at NEG."""
    dt = common.torch_dtype(cfg)
    d_in, nh, dh = _mlstm_dims(cfg)
    K = cfg.xlstm.conv_width
    cache: Cache = []
    for kind in _kinds(cfg):
        if kind == "m":
            st = _zero_mlstm_state(batch, nh, dh, device)
            st["conv"] = torch.zeros((batch, K - 1, d_in), dtype=dt,
                                     device=device)
        else:
            st = dict(zip(SLSTM_STATE,
                          _slstm_zero_state(cfg, batch, dt, device)))
        cache.append(st)
    return cache


def input_specs(cfg: ModelConfig, shape):
    """The step's inputs as meta tensors (the dry run's; no allocation)."""
    from repro_torch.models.api import token_specs
    return token_specs(shape)
