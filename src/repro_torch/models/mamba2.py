"""Mamba2 (SSD) block (port of ``repro.models.mamba2``).

The selective state-space recurrence is computed with the chunked SSD
algorithm (Dao & Gu, 2024): the sequence is split into chunks of length Q;
within a chunk the interactions are dense products, and the state is
carried across chunks by a short loop.  ``ssd_reference`` is the O(T)
step-by-step oracle.  Products run in float32 as in the JAX package; the
causal conv is its explicit sum of shifted products (not ``F.conv1d``),
so that no other summation order and no TF32 enter it.

With ``n_groups`` G > 1 (Mamba2's ngroups; Zamba2-7B-Instruct has 2), B
and C come in G groups of N and heads [g H/G, (g+1) H/G) read group g;
the chunked scan runs once per group, and the gated RMSNorm normalizes
each of G groups of d_inner / G channels apart.  ``conv_bias`` adds a
bias to the causal conv before its SiLU.

A block's decode state is {"ssm": (B, H, P, N) float32, "conv": (B, K-1,
C) model dtype}, batch on axis 0.  ``block_decode`` writes the new state
into those tensors in place (``copy_``), so a captured step keeps its
addresses.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common
from repro_torch.utils.sharding import (axis_divisor, constrain, head_local,
                                        on_mesh)

Params = Dict[str, Any]


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, n_heads, head_dim P, state N)."""
    d_inner = cfg.ssm.expand * cfg.d_model
    P = cfg.ssm.head_dim
    return d_inner, d_inner // P, P, cfg.ssm.d_state


def conv_channels(cfg: ModelConfig) -> int:
    d_inner, _, _, N = dims(cfg)
    return d_inner + 2 * cfg.ssm.n_groups * N   # x, B, C share the conv


def init_block(cfg: ModelConfig, gen: torch.Generator, dtype) -> Params:
    """Random block weights from ``gen`` (the JAX package's distributions)."""
    dm = cfg.d_model
    d_inner, H, P, N = dims(cfg)
    dev = gen.device
    C = conv_channels(cfg)
    d_proj = d_inner + C + H                  # z, x, B, C, dt
    p = {
        "in_proj": common.dense_init(gen, (dm, d_proj), 0, dtype),
        "conv_w": common.dense_init(gen, (cfg.ssm.conv_width, C), 0, dtype),
    }
    if cfg.ssm.conv_bias:
        p["conv_b"] = torch.zeros((C,), dtype=dtype, device=dev)
    return p | {
        "A_log": torch.zeros((H,), dtype=torch.float32, device=dev),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "gate_norm": torch.ones((d_inner,), dtype=dtype, device=dev),
        "out_proj": common.dense_init(gen, (d_inner, dm), 0, dtype),
        "norm": common.make_norm_params(cfg, dtype, dev),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_inner, H, P, N = dims(cfg)
    return torch.split(proj, [d_inner, conv_channels(cfg), H], dim=-1)


def _conv_sum(w: torch.Tensor, x: torch.Tensor,
              state: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width K before its activation: x (B, T,
    C), state (B, K-1, C) the last K-1 inputs (zeros when None).  Returns
    (sum_i xpad[:, i:i+T] * w[i] (+ bias), the new state), the sum taken
    in the JAX package's order."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xpad = torch.cat([state.to(x.dtype), x], dim=1)
    T = x.shape[1]
    out = sum(xpad[:, i:i + T] * w[i][None, None] for i in range(K))
    if bias is not None:
        out = out + bias
    new_state = xpad[:, -(K - 1):] if K > 1 else state
    return out, new_state


def _causal_conv(w: torch.Tensor, x: torch.Tensor,
                 state: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None):
    """SiLU of the causal conv; returns (out, new_state)."""
    out, new_state = _conv_sum(w, x, state, bias)
    return F.silu(out), new_state


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) log-decays -> (..., Q, Q) with [l, s] = sum_{s<j<=l}
    a_j, -inf above the diagonal."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD.

    x: (B, T, H, P); dt: (B, T, H) (post-softplus); A: (H,) negative;
    Bm, Cm: (B, T, N).  Returns (y (B, T, H, P) in x's dtype, final state
    (B, H, P, N) float32).  A T that is not a multiple of the chunk is
    padded with identity steps (dt = 0: decay 1, no input), whose outputs
    are cut off."""
    Bb, T, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, T)
    T0 = T
    if T % Q:
        pad = Q - T % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        T = T + pad
    nc = T // Q
    f32 = torch.float32

    a = dt * A[None, None]                                    # (B,T,H)
    xdt = x * dt[..., None]
    ac = a.reshape(Bb, nc, Q, H).transpose(2, 3)              # (B,nc,H,Q)
    xc = xdt.reshape(Bb, nc, Q, H, P).to(f32)
    Bc = Bm.reshape(Bb, nc, Q, N).to(f32)
    Cc = Cm.reshape(Bb, nc, Q, N).to(f32)

    L = torch.exp(_segsum(ac))                                # (B,nc,H,Q,Q)
    # intra-chunk (diagonal block) output
    CB = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y_diag = torch.einsum("bchls,bcshp->bclhp", CB[:, :, None] * L, xc)
    # per-chunk injected state
    a_cum = torch.cumsum(ac, dim=-1)                          # (B,nc,H,Q)
    decay_to_end = torch.exp(a_cum[..., -1:] - a_cum)
    chunk_states = torch.einsum(
        "bcsn,bchsp->bchpn", Bc,
        decay_to_end[..., None] * xc.permute(0, 1, 3, 2, 4))  # (B,nc,H,P,N)
    chunk_decay = torch.exp(a_cum[..., -1])                   # (B,nc,H)

    state = torch.zeros((Bb, H, P, N), dtype=f32, device=x.device) \
        if init_state is None else init_state.to(f32)
    prev = []
    for c in range(nc):
        prev.append(state)                                    # state BEFORE c
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)                    # (B,nc,H,P,N)

    # inter-chunk contribution
    state_decay = torch.exp(a_cum)                            # (B,nc,H,Q)
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, prev_states) \
        * state_decay.permute(0, 1, 3, 2)[..., None]
    y = (y_diag + y_off).reshape(Bb, T, H, P)[:, :T0]
    return y.to(x.dtype), state


def ssd_grouped(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int):
    """``ssd_chunked`` with B, C in groups: Bm, Cm (B, T, G, N), heads [g
    H/G, (g+1) H/G) reading group g.  One chunked scan per group; returns
    (y (B, T, H, P), final state (B, H, P, N) float32)."""
    G = Bm.shape[2]
    hg = x.shape[2] // G
    ys, states = [], []
    for g in range(G):
        h = slice(g * hg, (g + 1) * hg)
        y, st = ssd_chunked(x[:, :, h], dt[:, :, h], A[h], Bm[:, :, g],
                            Cm[:, :, g], chunk)
        ys.append(y)
        states.append(st)
    return torch.cat(ys, dim=2), torch.cat(states, dim=1)


def ssd_reference(x, dt, A, Bm, Cm, init_state=None):
    """Step-by-step recurrence oracle (float32)."""
    Bb, T, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    state = torch.zeros((Bb, H, P, N), dtype=f32, device=x.device) \
        if init_state is None else init_state.to(f32)
    ys = []
    for t in range(T):
        xt, dtt = x[:, t].to(f32), dt[:, t].to(f32)
        decay = torch.exp(dtt * A)                            # (B,H)
        state = state * decay[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", xt * dtt[..., None], Bm[:, t].to(f32))
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t].to(f32)))
    return torch.stack(ys, dim=1).to(x.dtype), state


def _gate(cfg: ModelConfig, p: Params, y: torch.Tensor,
          z: torch.Tensor) -> torch.Tensor:
    """rmsnorm(y * silu(z)) through the output projection."""
    return _gate_norm(cfg, p, y, z) @ p["out_proj"]


def _gate_norm(cfg: ModelConfig, p: Params, y: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """rmsnorm(y * silu(z)) with its weight; with G groups the norm runs
    over each group of d_inner / G channels apart."""
    g = y * F.silu(z.to(torch.float32)).to(y.dtype)
    G = cfg.ssm.n_groups
    if G == 1:
        return common.apply_norm("rmsnorm", p["gate_norm"], g)
    gf = g.to(torch.float32).unflatten(-1, (G, -1))
    gf = gf * torch.rsqrt(torch.mean(gf * gf, dim=-1, keepdim=True) + 1e-5)
    gf = gf.flatten(-2) * p["gate_norm"].to(torch.float32)
    return gf.to(g.dtype)


def _groups(cfg: ModelConfig, Bm: torch.Tensor, Cm: torch.Tensor):
    """B, C (..., G N) as (..., G, N) where G > 1; as they are else."""
    G, N = cfg.ssm.n_groups, cfg.ssm.d_state
    if G == 1:
        return Bm, Cm
    return Bm.unflatten(-1, (G, N)), Cm.unflatten(-1, (G, N))


def block_forward(cfg: ModelConfig, p: Params, u: torch.Tensor,
                  collect_state: bool = False):
    """Full-sequence Mamba2 block (pre-norm, residual outside).

    u: (B, T, D).  Returns (out (B, T, D), state | None) where state =
    {"ssm": (B, H, P, N), "conv": (B, K-1, C)} at the end of the
    sequence."""
    d_inner, H, P, N = dims(cfg)
    B, T, _ = u.shape
    GN = cfg.ssm.n_groups * N
    z, xBC, dt = _split_proj(cfg, u @ p["in_proj"])
    xBC, conv_state = _causal_conv(p["conv_w"], xBC, bias=p.get("conv_b"))
    x, Bm, Cm = torch.split(xBC, [d_inner, GN, GN], dim=-1)
    Bm, Cm = _groups(cfg, Bm, Cm)
    x = constrain(common.split_heads(x, H, P), "batch", None, "model", None)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"])
    # under a mesh the scan runs on each device's batch and head shard (a
    # grouped scan keeps its heads whole: a shard would split the groups)
    scan = ssd_chunked if cfg.ssm.n_groups == 1 else ssd_grouped
    y, final = head_local(functools.partial(scan, chunk=cfg.ssm.chunk),
                          (x, dt, A, Bm, Cm), (2, 2, 0, None, None),
                          H % axis_divisor("model") == 0
                          and cfg.ssm.n_groups == 1,
                          batched=(True, True, False, True, True),
                          out_head_dims=(2, 1))
    y = y + x * p["D"][None, None, :, None].to(x.dtype)
    out = constrain(_gate(cfg, p, y.reshape(B, T, d_inner), z),
                    "batch", None, None)
    state = {"ssm": final, "conv": conv_state} if collect_state else None
    return out, state


def block_decode(cfg: ModelConfig, p: Params, u: torch.Tensor,
                 state: Dict[str, torch.Tensor],
                 use_kernel: bool = False) -> torch.Tensor:
    """Single-token step.  u: (B, 1, D); ``state`` per ``block_forward``,
    updated in place.  Returns the block's output (B, 1, D).  With
    ``use_kernel``, on CUDA tensors everything between the two
    projections is ``kops.mamba2_decode`` (two kernels), which takes
    whole tensors on one card: under a mesh it raises.  On CPU tensors,
    or without ``use_kernel``, ``decode_between`` (its plain version)."""
    if use_kernel and u.is_cuda and on_mesh(u):
        raise NotImplementedError("mamba2 block_decode: the decode kernel "
                                  "takes whole tensors on one card, not "
                                  "a mesh's shards")
    proj = u @ p["in_proj"]
    if use_kernel and u.is_cuda:
        g = kops.mamba2_decode(proj[:, 0], state["conv"], state["ssm"], p,
                               cfg.ssm.n_groups)[:, None]
    else:
        g = decode_between(cfg, p, proj, state)
    return constrain(g @ p["out_proj"], "batch", None, None)


def decode_between(cfg: ModelConfig, p: Params, proj: torch.Tensor,
                   state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A decode step between the projections, as an op chain: the conv
    and SSM states updated in place from one token's ``proj`` (B, 1,
    d_proj), the gated, group-normalized y (B, 1, d_inner) returned
    (``kops.mamba2_decode``'s plain version)."""
    d_inner, H, P, N = dims(cfg)
    B = proj.shape[0]
    G = cfg.ssm.n_groups
    z, xBC, dt = _split_proj(cfg, proj)
    xBC, conv_state = _causal_conv(p["conv_w"], xBC, state["conv"],
                                   p.get("conv_b"))
    x, Bm, Cm = torch.split(xBC[:, 0], [d_inner, G * N, G * N], dim=-1)
    x = x.reshape(B, H, P).to(torch.float32)
    dt1 = F.softplus(dt[:, 0].to(torch.float32) + p["dt_bias"][None])
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt1 * A[None])                          # (B,H)
    if G == 1:
        ssm = state["ssm"] * decay[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", x * dt1[..., None], Bm.to(torch.float32))
        y = torch.einsum("bhpn,bn->bhp", ssm, Cm.to(torch.float32))
    else:
        # each head's group of B, C: (B, G, N) -> (B, H, N)
        Bh, Ch = (t.to(torch.float32).reshape(B, G, N)
                  .repeat_interleave(H // G, dim=1) for t in (Bm, Cm))
        ssm = state["ssm"] * decay[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", x * dt1[..., None], Bh)
        y = torch.einsum("bhpn,bhn->bhp", ssm, Ch)
    y = y + x * p["D"][None, :, None]
    y = y.reshape(B, 1, d_inner).to(proj.dtype)
    state["ssm"].copy_(ssm)
    state["conv"].copy_(conv_state)
    return _gate_norm(cfg, p, y, z)


def state_specs(cfg: ModelConfig, batch: int,
                device) -> Dict[str, torch.Tensor]:
    """A block's zero decode state (the JAX package's ``state_specs``)."""
    d_inner, H, P, N = dims(cfg)
    K = cfg.ssm.conv_width
    return {"ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, K - 1, conv_channels(cfg)),
                                dtype=common.torch_dtype(cfg), device=device)}
