"""OFDMA communication model (paper §II-A)."""
from __future__ import annotations

import math
from typing import Sequence

from repro_torch.core.environment import EdgeEnv
from repro_torch.core.request import BITS_PER_TOKEN, Request


def spectral_eff_up(env: EdgeEnv, h: float) -> float:
    """log2(1 + p_u h^2 / (N0 B_U)) — bits/s/Hz on the uplink."""
    return math.log2(1.0 + env.p_u * h * h / (env.N0 * env.B_U))


def spectral_eff_down(env: EdgeEnv, h: float) -> float:
    return math.log2(1.0 + env.p_d * h * h / (env.N0 * env.B_D))


def rate_up(env: EdgeEnv, r: Request, rho: float) -> float:
    return rho * env.B_U * spectral_eff_up(env, r.h)


def rate_down(env: EdgeEnv, r: Request, rho: float) -> float:
    return rho * env.B_D * spectral_eff_down(env, r.h)


def rho_min_up(env: EdgeEnv, r: Request) -> float:
    """Minimum uplink bandwidth fraction so the prompt uploads within T_U."""
    bits = r.s * BITS_PER_TOKEN
    return bits / (env.T_U * env.B_U * spectral_eff_up(env, r.h))


def rho_min_down(env: EdgeEnv, r: Request) -> float:
    """Minimum downlink fraction so the output downloads within T_D."""
    bits = r.n * BITS_PER_TOKEN
    return bits / (env.T_D * env.B_D * spectral_eff_down(env, r.h))


def uplink_feasible(env: EdgeEnv, reqs: Sequence[Request]) -> bool:
    return sum(rho_min_up(env, r) for r in reqs) <= 1.0 + 1e-12


def downlink_feasible(env: EdgeEnv, reqs: Sequence[Request]) -> bool:
    return sum(rho_min_down(env, r) for r in reqs) <= 1.0 + 1e-12
