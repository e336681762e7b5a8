"""One Mamba2 layer's decode step after its input projection, as two CUDA
kernels (``csrc/mamba2_decode.cu``): the causal conv's update, the
selective state's update and read, the D skip, the gate and the grouped
RMSNorm.

Its plain version is ``models.mamba2.decode_between``, the op chain
that ``block_decode`` runs without ``use_kernel`` (the CPU and the JAX
package's simplification take it); ``mamba2_decode_cuda`` computes the
same in float32 with the chain's roundings, its S C sum in a fixed order
of its own.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

LAUNCHES = {"mamba2_scan_step": 0, "mamba2_gate_norm": 0}


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous CUDA {dtype} tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def mamba2_decode_cuda(proj: torch.Tensor, conv_state: torch.Tensor,
                       ssm: torch.Tensor, conv_w: torch.Tensor,
                       conv_b: Optional[torch.Tensor], dt_bias: torch.Tensor,
                       A_log: torch.Tensor, D: torch.Tensor,
                       gate_norm: torch.Tensor, n_groups: int,
                       eps: float = 1e-5) -> torch.Tensor:
    """proj (B, d_inner + C + H) one token's [z | xBC | dt], conv_state
    (B, K-1, C), conv_w (K, C), conv_b (C,) or None, gate_norm (d_inner,)
    in the model's type (float32 or bfloat16); ssm (B, H, P, N), dt_bias,
    A_log, D (H,) float32.  Updates ssm and conv_state in place; returns
    the gated, group-normalized y (B, d_inner), the output projection's
    input."""
    dt = proj.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"proj: dtype {dt}, expected float32 or bfloat16")
    B, H, P, N = ssm.shape
    K = conv_w.shape[0]
    d_inner = H * P
    C = d_inner + 2 * n_groups * N
    if H % n_groups or d_inner % n_groups or K < 2:
        raise ValueError(f"mamba2_decode: H={H}, d_inner={d_inner} must be "
                         f"multiples of n_groups={n_groups}, K={K} >= 2")
    _check("proj", proj, dt, (B, d_inner + C + H))
    _check("conv_state", conv_state, dt, (B, K - 1, C))
    _check("conv_w", conv_w, dt, (K, C))
    if conv_b is not None:
        _check("conv_b", conv_b, dt, (C,))
    _check("gate_norm", gate_norm, dt, (d_inner,))
    _check("ssm", ssm, torch.float32, (B, H, P, N))
    for name, t in (("dt_bias", dt_bias), ("A_log", A_log), ("D", D)):
        _check(name, t, torch.float32, (H,))
    y = torch.empty((B, d_inner), dtype=dt, device=proj.device)
    out = torch.empty_like(y)
    lib = _build.library("mamba2_decode")
    rc = lib.mamba2_decode(
        proj.data_ptr(), conv_state.data_ptr(), conv_w.data_ptr(),
        None if conv_b is None else conv_b.data_ptr(), dt_bias.data_ptr(),
        A_log.data_ptr(), D.data_ptr(), ssm.data_ptr(), y.data_ptr(),
        gate_norm.data_ptr(), out.data_ptr(), B, H, P, N, n_groups, K, eps,
        int(dt == torch.bfloat16),
        torch.cuda.current_stream(proj.device).cuda_stream)
    _build.check(rc, "mamba2_decode")
    LAUNCHES["mamba2_scan_step"] += 1
    LAUNCHES["mamba2_gate_norm"] += 1
    return out
