"""DFTSP — optimal Depth-First Tree-Search with online tree-Pruning
(paper Algorithm 1, §III).

Outer loops (Algorithm 1 lines 2-9):
  * z = |I~| .. 1 (target batch size, decreasing => first hit is optimal);
  * requests sorted by slack tau~ descending; d = z .. |I~| sweeps the
    candidate pool F_d (the top-d slackiest requests).

Tree (for fixed z, d): candidates in F_d are grouped by output-length level
N_1 < N_2 < ... < N_K; a depth-k node chooses v_k = |S'_k| (how many level-k
requests are selected, cheapest-uplink first within the level).  DFS visits
children largest-count first (favoring short-output requests, paper
§III-C(1)) and depth-first so leaves are reached quickly.

Online pruning (paper §III-C(2)):
  * capacity prune — if the remaining levels cannot supply the missing
    z - sum(v) requests, skip the subtree and the lower-index siblings;
  * constraint prune — every P2 constraint is monotone in batch growth
    (uplink/downlink/memory LHS only increase, latency slack only
    decreases), so a partial selection that already violates one can never
    be completed: the branch is redundant and is cut.

Both louvers off (``prune=False``) + ascending child order reproduces the
brute-force benchmark of Table III.  ``SearchStats`` counts visited nodes
so benchmarks can report the complexity reduction.

Feasibility is monotone in z (any feasible batch stays feasible after
removing a request), so ``fast_z_bound`` computes a cheap per-constraint
upper bound on z and starts the descent there — the returned solution is
identical, only wasted top-of-range sweeps are skipped.  Disable it for
the literal Algorithm 1 node-count accounting.

Optimality note: the d-sweep is REQUIRED for optimality.  At
d = rank of the min-slack member of an optimal S*, the pool F_d contains
S* and every pool member has slack >= min-slack(S*); the cheapest-uplink
within-level greedy then dominates S* on every constraint (same counts per
level => same memory, <= uplink/downlink, >= min slack), so the count
vector of S* yields a feasible leaf.  ``d_sweep=False`` (single search on
the full pool) is a fast heuristic, not the paper algorithm.

Quantization as a decision variable: every entry point takes an explicit
``quant`` (``None`` = the env's deployed method, bit-identical to the
historical behavior), and ``dftsp_schedule_auto`` adds an outer METHOD
dimension to the z-descent — candidate methods are prefiltered by the
queue's accuracy demands, Pareto-dominated methods dropped, and (z,
method) pairs are visited batch-size-first so the first feasible hit is
still the maximum-throughput schedule; ties at equal z resolve to the
fastest (lowest beta) method.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import comm, problem
from repro_torch.core.environment import EdgeEnv
from repro_torch.core.quantization import QuantMethod, candidate_methods
from repro_torch.core.request import Request


@dataclass
class SearchStats:
    nodes_visited: int = 0
    leaves_checked: int = 0
    z_solved: int = 0
    pruned: int = 0


def _group_by_level(pool: Sequence[Request]) -> Tuple[List[int],
                                                      Dict[int, List[Request]]]:
    """Level groups N_1 < ... < N_K, cheapest-uplink first within a level,
    built from ONE sort of the pool (not a rescan per level)."""
    levels: List[int] = []
    groups: Dict[int, List[Request]] = {}
    for r in sorted(pool, key=lambda r: (r.n, r.rho_u)):
        if not levels or r.n != levels[-1]:
            levels.append(r.n)
            groups[r.n] = []
        groups[r.n].append(r)
    return levels, groups


def _annotate(env: EdgeEnv, reqs: Sequence[Request]) -> List[Request]:
    """Attach cached per-request quantities used in the inner loops."""
    cm = env.cost_model()
    for r in reqs:
        r.rho_u = comm.rho_min_up(env, r)        # type: ignore[attr-defined]
        r.rho_d = comm.rho_min_down(env, r)      # type: ignore[attr-defined]
        r.kv_tok = cm.kv_bytes_decode([r.n], env.s_max)   # decode KV bytes
        r.dec_flops = cm.decode_flops(env.s_max, [r.n])
    return list(reqs)


class _Ctx:
    """Precomputed (environment, method) quantities for incremental
    checks.  ``quant=None`` reads the env's deployed method.

    ``extra_s`` / ``rho_u0`` / ``rho_d0`` seat the search behind serial
    epoch time (earlier sub-batch compute + weight swap) and already-spent
    spectrum — the residual view a SECONDARY sub-batch of a split epoch
    is scheduled against.  All-zero is the paper's one-batch search.
    """

    def __init__(self, env: EdgeEnv, quant: Optional[QuantMethod] = None,
                 extra_s: float = 0.0, rho_u0: float = 0.0,
                 rho_d0: float = 0.0):
        self.env = env
        self.quant = quant or env.quant
        cm = env.cost_model()
        q = self.quant
        self.weight_mem = q.alpha_w * cm.weight_bytes()
        self.prefill_mem = q.alpha_a * cm.kv_bytes_prefill(env.s_max, 1)
        self.alpha_a = q.alpha_a
        self.prefill_flops = cm.prefill_flops(env.s_max, 1)
        self.beta = q.beta
        self.extra_s = extra_s
        self.rho_u0 = rho_u0
        self.rho_d0 = rho_d0


def _search(ctx: _Ctx, levels: List[int],
            groups: Dict[int, List[Request]], z: int,
            stats: SearchStats, prune: bool, order_desc: bool
            ) -> Optional[List[Request]]:
    """DFS over count vectors (v_1 .. v_K), see module docstring."""
    env = ctx.env
    K = len(levels)
    suffix_cap = [0] * (K + 1)
    for k in range(K - 1, -1, -1):
        suffix_cap[k] = suffix_cap[k + 1] + len(groups[levels[k]])

    # static per-z terms
    mem_base = ctx.weight_mem + ctx.prefill_mem * z
    if mem_base > env.M:
        return None
    comp_base = ctx.beta * ctx.prefill_flops * z / env.C

    chosen: List[Request] = []

    def partial_violates(rho_u: float, rho_d: float, mem: float,
                         dec: float, slack: float) -> bool:
        if (ctx.rho_u0 + rho_u > 1.0 + 1e-12
                or ctx.rho_d0 + rho_d > 1.0 + 1e-12):
            return True
        if mem_base + mem > env.M + 1e-6:
            return True
        t = (env.T_U + ctx.extra_s + comp_base
             + ctx.beta * dec / env.C + env.T_D)
        return t > slack + 1e-12

    def dfs(k: int, remaining: int, rho_u: float, rho_d: float,
            mem: float, dec: float, slack: float) -> Optional[List[Request]]:
        stats.nodes_visited += 1
        if prune and partial_violates(rho_u, rho_d, mem, dec, slack):
            stats.pruned += 1
            return None
        if remaining == 0:
            stats.leaves_checked += 1
            cand = list(chosen)
            if _check(env, cand, ctx.quant, extra_s=ctx.extra_s,
                      rho_u0=ctx.rho_u0, rho_d0=ctx.rho_d0):
                return cand
            return None
        if k == K:
            return None
        if prune and suffix_cap[k] < remaining:
            stats.pruned += 1
            return None
        g = groups[levels[k]]
        top = min(len(g), remaining)
        counts = range(top, -1, -1) if order_desc else range(0, top + 1)
        for v in counts:
            sel = g[:v]
            chosen.extend(sel)
            hit = dfs(k + 1, remaining - v,
                      rho_u + sum(r.rho_u for r in sel),
                      rho_d + sum(r.rho_d for r in sel),
                      mem + ctx.alpha_a * sum(r.kv_tok for r in sel),
                      dec + sum(r.dec_flops for r in sel),
                      min([slack] + [r.tau - r.t_w for r in sel]))
            del chosen[len(chosen) - v:]
            if hit is not None:
                return hit
        return None

    return dfs(0, z, 0.0, 0.0, 0.0, 0.0, float("inf"))


def _check(env: EdgeEnv, cand: List[Request],
           quant: Optional[QuantMethod] = None, extra_s: float = 0.0,
           rho_u0: float = 0.0, rho_d0: float = 0.0) -> bool:
    """Constraints (2b)-(2e) on a complete leaf (authoritative oracle)."""
    if rho_u0 + sum(r.rho_u for r in cand) > 1.0 + 1e-12:
        return False
    if rho_d0 + sum(r.rho_d for r in cand) > 1.0 + 1e-12:
        return False
    if not problem.memory_feasible(env, cand, quant):
        return False
    return problem.latency_feasible(env, cand, quant=quant, t_extra=extra_s)


def _z_upper_bound(env: EdgeEnv, pool: List[Request],
                   quant: Optional[QuantMethod] = None,
                   extra_s: float = 0.0, rho_u0: float = 0.0,
                   rho_d0: float = 0.0) -> int:
    """Cheap per-constraint bound on the max feasible batch size (sound:
    each constraint is evaluated with its own most-favorable requests)."""
    ctx = _Ctx(env, quant)
    n = len(pool)
    # bandwidth bounds
    z_u = _greedy_bound(sorted(r.rho_u for r in pool), 1.0 - rho_u0)
    z_d = _greedy_bound(sorted(r.rho_d for r in pool), 1.0 - rho_d0)
    # memory: weights + z*(prefill + cheapest decode KV)
    kvs = sorted(r.kv_tok * ctx.alpha_a for r in pool)
    z_m = 0
    used = ctx.weight_mem
    for kv in kvs:
        if used + ctx.prefill_mem + kv > env.M:
            break
        used += ctx.prefill_mem + kv
        z_m += 1
    # latency: z*(prefill) + cheapest decode flops vs best slack
    best_slack = max((r.tau - r.t_w for r in pool), default=0.0) \
        - env.T_U - env.T_D - extra_s
    decs = sorted(r.dec_flops for r in pool)
    z_t, tot = 0, 0.0
    for dflops in decs:
        tot += dflops
        t = ctx.beta * (ctx.prefill_flops * (z_t + 1) + tot) / env.C
        if t > best_slack:
            break
        z_t += 1
    return max(0, min(n, z_u, z_d, z_m, z_t))


def _greedy_bound(sorted_costs: List[float], budget: float) -> int:
    tot, z = 0.0, 0
    for c in sorted_costs:
        tot += c
        if tot > budget + 1e-12:
            break
        z += 1
    return z


def _solve_z(ctx: _Ctx, coeff: problem.P2Coefficients,
             pool: List[Request], z: int, stats: SearchStats,
             prune: bool, order_desc: bool, d_sweep: bool
             ) -> Optional[List[Request]]:
    """Algorithm 1's inner body for one target batch size z (slack-ranked
    d-sweep over candidate pools, then the pruned DFS)."""
    ranked = sorted(pool, key=lambda r: coeff.tau_tilde(r, z),
                    reverse=True)
    d_values = range(z, len(pool) + 1) if d_sweep else [len(pool)]
    for d in d_values:
        F_d = ranked[:d]
        levels, groups = _group_by_level(F_d)
        hit = _search(ctx, levels, groups, z, stats, prune, order_desc)
        if hit is not None:
            return hit
    return None


def dftsp_schedule(env: EdgeEnv, requests: Sequence[Request],
                   prune: bool = True, order_desc: bool = True,
                   d_sweep: bool = True, fast_z_bound: bool = True,
                   stats: Optional[SearchStats] = None,
                   quant: Optional[QuantMethod] = None,
                   extra_s: float = 0.0, rho_u0: float = 0.0,
                   rho_d0: float = 0.0
                   ) -> Tuple[List[Request], SearchStats]:
    """Run Algorithm 1.  Returns (optimal batch S, search stats).

    ``prune=False, order_desc=False, fast_z_bound=False`` is the
    brute-force benchmark of Table III (same solution, more nodes).
    ``quant`` evaluates every constraint under an explicit method instead
    of the env's deployed one.  ``extra_s``/``rho_u0``/``rho_d0`` run the
    search against a residual epoch (time already queued serially ahead
    of this batch, spectrum already committed) — the secondary-sub-batch
    view of ``dftsp_schedule_split``; zeros are the paper's search.
    """
    stats = stats or SearchStats()
    pool = problem.filter_accuracy(env, requests, quant)
    if not pool:
        return [], stats
    pool = _annotate(env, pool)
    ctx = _Ctx(env, quant, extra_s=extra_s, rho_u0=rho_u0, rho_d0=rho_d0)
    coeff = problem.P2Coefficients(env, quant, extra_s=extra_s)

    z_start = _z_upper_bound(env, pool, quant, extra_s=extra_s,
                             rho_u0=rho_u0, rho_d0=rho_d0) \
        if fast_z_bound else len(pool)
    for z in range(z_start, 0, -1):
        hit = _solve_z(ctx, coeff, pool, z, stats, prune, order_desc,
                       d_sweep)
        if hit is not None:
            stats.z_solved = z
            return hit, stats
    return [], stats


def dftsp_schedule_auto(env: EdgeEnv, requests: Sequence[Request],
                        methods: Optional[Sequence[QuantMethod]] = None,
                        prune: bool = True, order_desc: bool = True,
                        d_sweep: bool = True, fast_z_bound: bool = True,
                        stats: Optional[SearchStats] = None
                        ) -> Tuple[List[Request], QuantMethod, SearchStats]:
    """Algorithm 1 with the quantization method as an OUTER decision
    dimension.  Returns (optimal batch S, chosen method, stats).

    Candidate methods are prefiltered by the queue's accuracy demands and
    Pareto-pruned (``quantization.candidate_methods``); the z-descent then
    runs globally across the surviving methods — at each z, methods are
    tried fastest-first, so the first feasible hit maximizes batch size
    (the throughput objective) and breaks ties toward the lowest compute
    time.  With an empty queue (or no admissible method) the env's
    deployed method is returned unchanged.
    """
    stats = stats or SearchStats()
    model = env.model.arch_id
    cands = candidate_methods(model, accuracies=[r.a for r in requests],
                              methods=methods)
    # rho_u/rho_d/kv_tok/dec_flops are quant-independent (alpha/beta scale
    # them inside _Ctx / the oracles), so annotate the queue ONCE and share
    # the cached quantities across every candidate method's pool.
    annotated = _annotate(env, requests)
    entries = []          # (method, ctx, coeff, pool, z upper bound)
    for m in cands:
        pool = problem.filter_accuracy(env, annotated, m)
        if not pool:
            continue
        bound = _z_upper_bound(env, pool, m) if fast_z_bound else len(pool)
        if bound < 1:
            continue
        entries.append((m, _Ctx(env, m), problem.P2Coefficients(env, m),
                        pool, bound))
    if not entries:
        return [], env.quant, stats

    for z in range(max(e[4] for e in entries), 0, -1):
        for m, ctx, coeff, pool, bound in entries:
            if bound < z:
                continue
            hit = _solve_z(ctx, coeff, pool, z, stats, prune, order_desc,
                           d_sweep)
            if hit is not None:
                stats.z_solved = z
                return hit, m, stats
    return [], env.quant, stats


def dftsp_schedule_split(env: EdgeEnv, requests: Sequence[Request],
                         methods: Optional[Sequence[QuantMethod]] = None,
                         swap_record: Optional[dict] = None,
                         prune: bool = True, order_desc: bool = True,
                         d_sweep: bool = True, fast_z_bound: bool = True,
                         stats: Optional[SearchStats] = None,
                         rho_u0: float = 0.0, rho_d0: float = 0.0,
                         extra_s: float = 0.0
                         ) -> Tuple[List[Tuple[List[Request], QuantMethod]],
                                    SearchStats]:
    """Split-epoch extension of ``dftsp_schedule_auto``: one epoch's queue
    may be served as TWO sequential sub-batches at different quantization
    methods, with the measured weight-swap latency between them charged in
    the P2 epoch time (DESIGN.md §1.1).

    Returns ``([(batch, method), ...], stats)`` — one entry for a single-
    method epoch (identical to ``dftsp_schedule_auto``'s answer), two when
    a split strictly serves more requests with the swap cost charged.

    The descent explores split points (primary method x primary batch x
    secondary method) with online pruning:

    * **swap-domination prune** — a (primary, secondary) pair is dominated
      when the swap cost plus the primary's compute eats the residual
      queue's entire slack: the secondary's cheap z-bound at the charged
      serial offset is 0, so no sub-batch can repay the swap.  Skipped
      without searching (``stats.pruned``).
    * **capacity prune** — a pair whose optimistic total (primary size +
      secondary z-bound) cannot beat the incumbent is skipped.

    A split is only adopted when it serves STRICTLY more than the best
    single-method schedule — at equal service the swap only adds epoch
    time — so split throughput >= single-method throughput by
    construction, with swap costs charged (the property
    ``tests/test_quant_splits.py`` pins).
    """
    from repro_torch.core.quantization import swap_seconds
    stats = stats or SearchStats()
    kw = dict(prune=prune, order_desc=order_desc, d_sweep=d_sweep,
              fast_z_bound=fast_z_bound)

    best_sel, best_m, _ = dftsp_schedule_auto(
        env, requests, methods=methods, stats=stats, **kw)
    if not best_sel:
        return [], stats
    best: List[Tuple[List[Request], QuantMethod]] = [(best_sel, best_m)]
    best_total = len(best_sel)

    model = env.model.arch_id
    cands = candidate_methods(model, accuracies=[r.a for r in requests],
                              methods=methods)
    annotated = _annotate(env, requests)
    if len(cands) < 2 or best_total >= len(annotated):
        return best, stats        # nothing left to split toward

    for m_p in cands:
        # primary sub-batch: the best batch this method alone can serve
        if m_p.name == best_m.name:
            sel_p = best_sel
        else:
            sel_p, _ = dftsp_schedule(env, annotated, quant=m_p,
                                      stats=stats, extra_s=extra_s,
                                      rho_u0=rho_u0, rho_d0=rho_d0, **kw)
        if not sel_p:
            continue
        taken = {r.rid for r in sel_p}
        residual = [r for r in annotated if r.rid not in taken]
        if not residual:
            continue
        t_primary = problem.batch_compute_time(env, sel_p, quant=m_p)
        rho_u1 = rho_u0 + sum(r.rho_u for r in sel_p)
        rho_d1 = rho_d0 + sum(r.rho_d for r in sel_p)
        for m_s in cands:
            if m_s.name == m_p.name:
                continue
            pool_s = problem.filter_accuracy(env, residual, m_s)
            if not pool_s:
                continue
            serial = extra_s + t_primary + swap_seconds(swap_record,
                                                        m_p, m_s)
            z2_bound = _z_upper_bound(env, pool_s, m_s, extra_s=serial,
                                      rho_u0=rho_u1, rho_d0=rho_d1)
            if z2_bound < 1:          # swap-domination prune
                stats.pruned += 1
                continue
            if len(sel_p) + min(z2_bound, len(pool_s)) <= best_total:
                stats.pruned += 1     # capacity prune
                continue
            sel_s, _ = dftsp_schedule(env, pool_s, quant=m_s, stats=stats,
                                      extra_s=serial, rho_u0=rho_u1,
                                      rho_d0=rho_d1, **kw)
            if len(sel_p) + len(sel_s) > best_total:
                best = [(sel_p, m_p), (sel_s, m_s)]
                best_total = len(sel_p) + len(sel_s)
    stats.z_solved = best_total
    return best, stats
