"""Batch schedulers: DFTSP (paper Algorithm 1) + the paper's §IV baselines.

* ``dftsp``         — optimal tree search (core/dftsp.py), the contribution;
* ``brute_force``   — same search without pruning/ordering (Table III bench);
* ``static_batching`` (StB) — fixed batch size derived offline from the epoch
  duration and LLM parameters so the *worst-case* batch never overflows
  memory or the epoch deadline; requests admitted FIFO up to that size;
* ``no_batching``   (NoB) — each accelerator unit serves one request at a
  time (n_units concurrent singles per epoch);
* ``greedy``        — slack-ordered greedy admission (a beyond-paper baseline
  that is the natural "good heuristic" anchor for DFTSP's optimality).

Every scheduler has the same signature:
    schedule(env, requests) -> (selected: List[Request], stats: SearchStats)
and must return a batch that satisfies P1 (the simulator re-checks).
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.core import comm, problem
from repro_torch.core.dftsp import SearchStats, dftsp_schedule
from repro_torch.core.environment import EdgeEnv
from repro_torch.core.request import Request

Scheduler = Callable[[EdgeEnv, Sequence[Request]],
                     Tuple[List[Request], SearchStats]]


def dftsp(env: EdgeEnv, requests: Sequence[Request]):
    return dftsp_schedule(env, requests)


def brute_force(env: EdgeEnv, requests: Sequence[Request]):
    """Tree search without pruning / child ordering / z upper-bounding —
    the Table III benchmark.  Same (optimal) answer, many more nodes."""
    return dftsp_schedule(env, requests, prune=False, order_desc=False,
                          fast_z_bound=False)


def exhaustive(env: EdgeEnv, requests: Sequence[Request],
               max_n: int = 18):
    """Literal subset enumeration (oracle for optimality tests only)."""
    pool = problem.filter_accuracy(env, requests)
    if len(pool) > max_n:
        raise ValueError(f"exhaustive() is capped at {max_n} requests")
    stats = SearchStats()
    best: List[Request] = []
    for z in range(len(pool), 0, -1):
        if z <= len(best):
            break
        for cand in itertools.combinations(pool, z):
            stats.nodes_visited += 1
            if problem.feasible(env, list(cand), check_accuracy=False):
                best = list(cand)
                break
        if best:
            break
    stats.z_solved = len(best)
    return best, stats


def _static_batch_key(env: EdgeEnv) -> tuple:
    """Cache key over exactly the EdgeEnv fields the derivation reads.
    (EdgeEnv itself is unhashable: QuantMethod carries a dPPL dict.)"""
    q = env.quant
    return (env.model, q.name, q.weight_bits, q.act_bits, q.beta,
            env.C, env.M, env.T_E, env.T_U, env.T_D, env.s_max,
            env.paper_faithful)


_STATIC_BATCH_CACHE: Dict[tuple, int] = {}


def static_batch_size(env: EdgeEnv) -> int:
    """StB's offline batch size: largest B such that a batch of B
    *worst-case* requests (max output level, median channel) is feasible on
    memory and the epoch compute budget (paper §IV: 'set batch size based on
    epoch duration and LLM parameters to avoid GPU overflow').

    Memoized: the result is a pure function of the frozen EdgeEnv, so the
    O(B_max) re-derivation runs once per environment, not once per epoch.
    """
    key = _static_batch_key(env)
    cached = _STATIC_BATCH_CACHE.get(key)
    if cached is not None:
        return cached
    cm = env.cost_model()
    q = env.quant
    n_max = env.s_max                      # worst-case output level
    B = 0
    while True:
        b = B + 1
        mem = (q.alpha_w * cm.weight_bytes()
               + q.alpha_a * (cm.kv_bytes_prefill(env.s_max, b)
                              + cm.kv_bytes_decode([n_max] * b, env.s_max)))
        t = q.beta * (cm.prefill_flops(env.s_max, b)
                      + cm.decode_flops(env.s_max, [n_max] * b)) / env.C
        if mem > env.M or env.T_U + t + env.T_D > env.T_E:
            break
        B = b
        if B >= 4096:                      # safety rail
            break
    _STATIC_BATCH_CACHE[key] = B
    return B


def static_batching(env: EdgeEnv, requests: Sequence[Request]):
    """StB: FIFO admission up to the precomputed size; per-request comm and
    deadline checks still apply (infeasible requests are passed over)."""
    stats = SearchStats()
    B = static_batch_size(env)
    pool = problem.filter_accuracy(env, requests)
    pool = sorted(pool, key=lambda r: r.arrival)
    sel: List[Request] = []
    rho_u = rho_d = 0.0
    for r in pool:
        if len(sel) == B:
            break
        stats.nodes_visited += 1
        ru, rd = comm.rho_min_up(env, r), comm.rho_min_down(env, r)
        if rho_u + ru > 1.0 or rho_d + rd > 1.0:
            continue
        cand = sel + [r]
        if not problem.latency_feasible(env, cand):
            continue
        if not problem.memory_feasible(env, cand):
            break
        sel, rho_u, rho_d = cand, rho_u + ru, rho_d + rd
    stats.z_solved = len(sel)
    return sel, stats


def no_batching(env: EdgeEnv, requests: Sequence[Request]):
    """NoB: n_units accelerators, one request each, no batching.  Each unit
    has 1/n_units of the aggregate compute and memory.  A lone request runs
    at its true prompt length (padding to s' exists only for batching)."""
    stats = SearchStats()
    C_unit, M_unit = env.C / env.n_units, env.M / env.n_units
    cm = env.cost_model()
    q = env.quant
    pool = problem.filter_accuracy(env, requests)
    pool = sorted(pool, key=lambda r: r.arrival)
    sel: List[Request] = []
    rho_u = rho_d = 0.0
    for r in pool:
        if len(sel) == env.n_units:
            break
        stats.nodes_visited += 1
        ru, rd = comm.rho_min_up(env, r), comm.rho_min_down(env, r)
        if rho_u + ru > 1.0 or rho_d + rd > 1.0:
            continue
        mem = (q.alpha_w * cm.weight_bytes()
               + q.alpha_a * (cm.kv_bytes_prefill(r.s, 1)
                              + cm.kv_bytes_decode([r.n], r.s)))
        if mem > M_unit:
            continue
        t = q.beta * (cm.prefill_flops(r.s, 1)
                      + cm.decode_flops(r.s, [r.n])) / C_unit
        if r.t_w + env.T_U + t + env.T_D > r.tau + 1e-12:
            continue
        sel, rho_u, rho_d = sel + [r], rho_u + ru, rho_d + rd
    stats.z_solved = len(sel)
    return sel, stats


def greedy(env: EdgeEnv, requests: Sequence[Request]):
    """Slack-then-cost greedy admission (beyond-paper heuristic anchor)."""
    stats = SearchStats()
    pool = problem.filter_accuracy(env, requests)
    pool = sorted(pool, key=lambda r: (r.n, -(r.tau - r.t_w)))
    sel: List[Request] = []
    for r in pool:
        stats.nodes_visited += 1
        cand = sel + [r]
        if problem.feasible(env, cand, check_accuracy=False):
            sel = cand
    stats.z_solved = len(sel)
    return sel, stats


def nob_feasible(env: EdgeEnv, sel: Sequence[Request]) -> bool:
    """Validity oracle for a NoB assignment (per-unit, true prompt length)."""
    if len(sel) > env.n_units:
        return False
    if not (comm.uplink_feasible(env, sel)
            and comm.downlink_feasible(env, sel)):
        return False
    C_unit, M_unit = env.C / env.n_units, env.M / env.n_units
    cm = env.cost_model()
    q = env.quant
    for r in sel:
        mem = (q.alpha_w * cm.weight_bytes()
               + q.alpha_a * (cm.kv_bytes_prefill(r.s, 1)
                              + cm.kv_bytes_decode([r.n], r.s)))
        t = q.beta * (cm.prefill_flops(r.s, 1)
                      + cm.decode_flops(r.s, [r.n])) / C_unit
        if mem > M_unit or r.t_w + env.T_U + t + env.T_D > r.tau + 1e-12:
            return False
    return True


SCHEDULERS: Dict[str, Scheduler] = {
    "dftsp": dftsp,
    "brute_force": brute_force,
    "stb": static_batching,
    "nob": no_batching,
    "greedy": greedy,
}


def get_scheduler(name: str) -> Scheduler:
    return SCHEDULERS[name]
