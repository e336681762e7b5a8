"""The port's continuous path: chunked decode, the paged arena and
``ContinuousRuntime``.

Within the port (reduced BLOOM): chunked decode driven to completion
equals ``generate`` and ``generate_reference`` bit for bit for any chunk
size and precision; the paged path equals the slab path bit for bit,
through refill, eviction and immediate EOS; a preempted-then-resumed row
equals an uninterrupted one; the host copies are counted.

Against the JAX package, on the same float32 weights (handed over through
``repro_torch.bridge``) and the same frozen traffic, both runtimes are run
live here and their counts compared: ``examples/serve_continuous.py``'s
single-engine node under ``dftsp`` and ``dftsp:quant=auto``,
``benchmarks/paged_vs_slab.py``'s two-engine paged node under
``multi-dftsp``, and a preempting run (slab and paged) whose resumed
requests' tokens must equal the JAX package's.  The JAX side runs its
``use_kernel=False`` gather path (its Pallas kernels do not run on this
CPU).

The runtime counts below (mid-epoch admissions, top-ups, the block
series) depend on every cohort step ``t`` the executor reads, which the
port's loop, like the JAX package's, stops where no row can emit
(``tests/test_torch_decode_graph.py`` holds ``t`` itself to the JAX
package's).
"""
from __future__ import annotations

import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import get_arch as jget_arch  # noqa: E402
from repro.core.environment import paper_env as jpaper_env  # noqa: E402
from repro.core.multi import MultiLLMEnv as JMultiEnv  # noqa: E402
from repro.core.multi import random_tagger as jtagger  # noqa: E402
from repro.core.request import ReplayGenerator as JReplay  # noqa: E402
from repro.core.request import RequestGenerator as JGen  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import kv_arena as jka  # noqa: E402
from repro.serving import runtime as jrt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.core.environment import paper_env  # noqa: E402
from repro_torch.core.multi import MultiLLMEnv, random_tagger  # noqa: E402
from repro_torch.core.request import ReplayGenerator  # noqa: E402
from repro_torch.core.request import RequestGenerator  # noqa: E402
from repro_torch.serving import DecodeState  # noqa: E402
from repro_torch.serving.engine import ServingEngine, tiny_engine  # noqa: E402
from repro_torch.serving.kv_arena import ZERO_PAGE, KVArena  # noqa: E402
from repro_torch.serving.runtime import (ContinuousRuntime,  # noqa: E402
                                         EngineContinuousExecutor)
from test_torch_serving import _TransferProbe  # noqa: E402

ENGINE_KW = dict(batch_capacity=4, s_max=24, n_max=8)


def assert_same(a, b):
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    assert a.batch == b.batch


@functools.lru_cache(maxsize=None)
def _engine(eos_id=0):
    eng = tiny_engine("bloom-3b", device="cpu", seed=1, **ENGINE_KW)
    if eos_id:
        eng = ServingEngine(eng.cfg, params=eng._raw_params, device="cpu",
                            eos_id=eos_id, **ENGINE_KW)
    return eng


def _arena(eng, bt=8):
    return KVArena.for_engines(eng, block_tokens=bt)


def _drive(eng, st, k=3):
    while True:
        st = eng.generate_chunked(st, k)
        out, lengths, done, t = eng.poll_chunked(st)
        if eng.exhausted(lengths, done, st.caps_host, t):
            return st, out, lengths


PROMPTS = [[5, 6, 7], [0, 0], [9, 9, 9, 9, 1], [3]]


# -- chunked == generate == generate_reference ------------------------------


@pytest.mark.parametrize("bits", [0, 8, (8, 8), 4])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_chunked_equals_generate_and_reference(bits, k):
    eng = _engine()
    caps = [8, 0, 5, 3]                 # a cap-0 row, a pad-token prompt
    want = eng.generate(PROMPTS, caps, quant_bits=bits)
    assert_same(want, eng.generate_reference(PROMPTS, caps, quant_bits=bits))
    assert_same(eng.generate_via_chunks(PROMPTS, caps, k=k, quant_bits=bits),
                want)
    assert want.lengths[1] == 0


@pytest.mark.parametrize("k", [1, 3, 8])
def test_paged_equals_slab(k):
    eng = _engine()
    caps = [8, 0, 5, 3]
    want = eng.generate_via_chunks(PROMPTS, caps, k=k)
    for bt in (4, 8, 16):
        arena = _arena(eng, bt)
        assert_same(eng.generate_via_chunks(PROMPTS, caps, k=k, arena=arena),
                    want)
        assert arena.free_pages == arena.total_pages
    assert_same(eng.generate_via_chunks([], [], k=k, arena=_arena(eng)),
                eng.generate([], []))


def test_state_reentry_any_split():
    eng = _engine()
    one = eng.poll_chunked(eng.generate_chunked(
        eng.start_chunked(PROMPTS[:2], [8, 8]), eng.n_max))
    mixed = eng.start_chunked(PROMPTS[:2], [8, 8])
    for k in (2, 3, eng.n_max):
        mixed = eng.generate_chunked(mixed, k)
    two = eng.poll_chunked(mixed)
    for a, b in zip(one[:3], two[:3]):
        np.testing.assert_array_equal(a, b)
    assert one[3] == two[3] == eng.n_max


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_immediate_eos(paged):
    ref = _engine().generate_reference([[9, 8, 7]], [6])
    tok0 = int(ref.tokens[0, 0])
    eng = _engine(eos_id=tok0)
    got = eng.generate_via_chunks([[9, 8, 7], [4, 4]], [6, 6], k=3,
                                  arena=_arena(eng) if paged else None)
    assert_same(got, eng.generate([[9, 8, 7], [4, 4]], [6, 6]))
    assert got.lengths[0] == 1 and got.tokens[0, 0] == tok0


def _refill_run(eng, arena, evict=False):
    st = eng.start_chunked(PROMPTS[:3], [8, 2, 8], arena=arena)
    st = eng.generate_chunked(st, 3)
    _, lengths, done, t = eng.poll_chunked(st)
    assert lengths[1] == 2 and t == 3
    if arena is not None:
        st = eng.release_slots(st, [1])
    if evict:
        st = eng.evict_slots(st, [0])
    st = eng.refill_chunked(st, [1, 3], [[9, 9, 9], [1, 2]], [8, 3],
                            t_now=t)
    assert st.caps_host.tolist() == [0 if evict else 8, 5, 8, 3]
    st, out, lengths = _drive(eng, st, k=2)
    if arena is not None:
        eng.release_all(st)
    return out, lengths


@pytest.mark.parametrize("evict", [False, True])
def test_paged_refill_and_eviction_equal_slab(evict):
    eng = _engine()
    out, lengths = _refill_run(eng, None, evict)
    for bt in (4, 8):
        arena = _arena(eng, bt)
        pout, plen = _refill_run(eng, arena, evict)
        np.testing.assert_array_equal(pout, out)
        np.testing.assert_array_equal(plen, lengths)
        assert arena.free_pages == arena.total_pages
        for leaf in arena.buffers().values():       # never written
            assert not leaf[:, ZERO_PAGE].any()
    assert lengths[1] == 5                          # clamped to headroom


def test_refill_leaves_live_rows_untouched():
    eng = _engine()
    want = eng.generate_via_chunks(PROMPTS[:1], [8], k=2)
    st = eng.start_chunked(PROMPTS[:1], [8])
    st = eng.generate_chunked(st, 2)
    st = eng.refill_chunked(st, [2], [[7, 7]], [4], t_now=2)
    st, out, lengths = _drive(eng, st, k=2)
    np.testing.assert_array_equal(out[0], want.tokens[0])


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_refill_cap_max_zero_and_empty_slots_are_noops(paged):
    eng = _engine()
    arena = _arena(eng) if paged else None
    st = eng.start_chunked(PROMPTS[:1], [4], arena=arena)
    free0 = arena.free_pages if paged else None
    assert eng.refill_chunked(st, [1], [[1, 2]], [4], t_now=0,
                              cap_max=0) is st
    assert eng.refill_chunked(st, [], [], [], t_now=0) is st
    assert eng.refill_chunked(st, [1], [[1, 2]], [4], t_now=8) is st
    if paged:
        assert arena.free_pages == free0
        eng.release_all(st)


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_resumed_row_equals_uninterrupted(paged):
    eng = _engine()
    prompt = [3, 5, 7, 2]

    def arena():
        return _arena(eng) if paged else None

    st, out, lengths = _drive(eng, eng.start_chunked([prompt], [8],
                                                     arena=arena()))
    ref = out[0][:lengths[0]].copy()
    assert lengths[0] == 8
    st = eng.start_chunked([prompt, [1, 2], [9, 4, 6]], [8, 8, 8],
                           arena=arena())
    st = eng.generate_chunked(st, 3)
    out, lengths, _, _ = eng.poll_chunked(st)
    prefix = [int(x) for x in out[0][:lengths[0]]]
    assert 0 < len(prefix) < len(ref)
    st = eng.evict_slots(st, [0])
    _drive(eng, st)
    st, out, lengths = _drive(eng, eng.start_chunked(
        [prompt], [8], arena=arena(), prefixes=[prefix]))
    np.testing.assert_array_equal(out[0][:lengths[0]], ref)


def test_poll_without_tokens():
    eng = _engine()
    st = eng.generate_chunked(eng.start_chunked(PROMPTS[:2], [8, 3]), 4)
    out, lengths, done, t = eng.poll_chunked(st, with_tokens=False)
    full = eng.poll_chunked(st)
    assert out is None and t == full[3] == 4
    np.testing.assert_array_equal(lengths, full[1])
    np.testing.assert_array_equal(done, full[2])
    assert isinstance(st, DecodeState)


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_host_copies(monkeypatch, paged):
    """One host->device copy per start/refill, one device->host copy per
    poll, no device value read inside a segment; the paged path adds one
    table re-ship at a boundary whose rows changed, and none otherwise."""
    eng = _engine()
    eng.params_for(8)                   # quantize outside the probe
    arena = _arena(eng, 4) if paged else None
    probe = _TransferProbe(monkeypatch)

    def counted(fn):
        before = dict(probe.copies)
        res = fn()
        return res, {k: probe.copies[k] - before[k] for k in before
                     if probe.copies[k] != before[k]}

    st, c = counted(lambda: eng.start_chunked(PROMPTS[:2], [8, 3],
                                              quant_bits=8, arena=arena))
    assert c == {"to": 1}
    # the first segment ships the new cohort's table; the next, still
    # inside the first write block, changes no row and ships nothing
    st, c = counted(lambda: eng.generate_chunked(st, 1))
    assert c == ({"to": 1} if paged else {})
    st, c = counted(lambda: eng.generate_chunked(st, 1))
    assert c == {}
    st, c = counted(lambda: eng.generate_chunked(st, 5))
    assert c == ({"to": 1} if paged else {})       # top-up: table re-ship
    (_, _, _, t), c = counted(lambda: eng.poll_chunked(st))
    assert c == {"cpu": 1} and t == 7
    st, c = counted(lambda: eng.refill_chunked(st, [2], [[1, 2]], [1],
                                               t_now=t))
    assert c == {"to": 1}
    (_, _, _, t), c = counted(lambda: eng.poll_chunked(st, False))
    assert c == {"cpu": 1}
    monkeypatch.undo()
    assert not any(probe.syncs.values()), probe.syncs
    if paged:
        eng.release_all(st)


# -- the runtime against the JAX package's -----------------------------------


def _pair(arch, dims, kw, seed=0):
    """(JAX engine, port engine) at float32 on the same weights."""
    jcfg = jget_arch(arch).scaled(**dims, dtype="float32")
    je = jeng.ServingEngine(jcfg, seed=seed, **kw)
    te = ServingEngine(
        get_arch(arch).scaled(**dims, dtype="float32"),
        params=bridge.from_jax_params(jax.device_get(je._raw_params),
                                      device="cpu"),
        device="cpu", **kw)
    return je, te


def _counts(m):
    return dict(arrived=m.arrived, served=m.served, dropped=m.dropped,
                tokens=m.generated_tokens,
                admitted_mid_epoch=m.admitted_mid_epoch,
                selected=[t.selected_rids for t in m.traces],
                finished=[t.finished_rids for t in m.traces],
                queue=m.final_queue_rids, topups=m.kv_topup_pages,
                blocks=[t.kv_blocks_in_use for t in m.traces])


@pytest.mark.parametrize("spec", ["dftsp", "dftsp:quant=auto"])
def test_serve_continuous_example_counts_match_jax(spec):
    """``examples/serve_continuous.py``'s node and frozen traffic (rate 8,
    k = 2, 6 epochs) under ``dftsp`` and under ``dftsp:quant=auto`` (Table
    II coefficients; its cohorts start at W8A8, W8A16 and W16A16): the same
    counts and methods, epoch by epoch."""
    dims = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
                vocab=512)
    je, te = _pair("bloom-3b", dims, dict(batch_capacity=8, s_max=32,
                                          n_max=16))
    epochs, rate = 6, 8.0
    runs = []
    for env, replay, ex, rt, eng in (
            (jpaper_env("bloom-3b", "W8A16"), JReplay,
             jrt.EngineContinuousExecutor, jrt.ContinuousRuntime, je),
            (paper_env("bloom-3b", "W8A16"), ReplayGenerator,
             EngineContinuousExecutor, ContinuousRuntime, te)):
        traffic = replay.poisson(rate, (epochs - 1) * env.T_E, seed=0,
                                 lengths=(4, 8, 16))
        runs.append(rt(env, spec, ex(eng, seed=0), k=2).run(
            gen=replay(traffic.requests), n_epochs=epochs, seed=0,
            warmup_epochs=0))
    want, got = (_counts(m) for m in runs)
    assert got == want
    assert got["admitted_mid_epoch"] > 0 and got["tokens"] > 0
    assert runs[1].served_by_method == runs[0].served_by_method
    assert [t.quants for t in runs[1].traces] == \
        [t.quants for t in runs[0].traces]


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_preemption_resume_matches_jax(paged):
    """Priority preemption on the engine path (evict, spill the delivered
    prefix, re-prefill and replay it through the forced buffers, burned off
    the segment grid by the executor's eager fast-forward): the same
    preemptions, resumes and served requests as the JAX package, and every
    served request's tokens equal the JAX package's."""
    dims = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=512,
                vocab=512)
    je, te = _pair("bloom-3b", dims, dict(batch_capacity=3, s_max=16,
                                          n_max=8))
    runs, outputs = [], []
    for env, gen, ka, ex, rt, eng in (
            (jpaper_env("bloom-3b", "W8A16"), JGen, jka.KVArena,
             jrt.EngineContinuousExecutor, jrt.ContinuousRuntime, je),
            (paper_env("bloom-3b", "W8A16"), RequestGenerator, KVArena,
             EngineContinuousExecutor, ContinuousRuntime, te)):
        arena = ka.for_engines(eng, block_tokens=8) if paged else None
        cexec = ex(eng, seed=0, collect_tokens=True, arena=arena)
        m = rt(env, "dftsp", cexec, k=2, preemption=True, max_preemptions=2,
               backoff_boundaries=1).run(
            gen=gen(rate=8, seed=3, lengths=(4, 8), tau_range=(0.5, 6.0),
                    priorities=(0, 1, 2)),
            n_epochs=4, warmup_epochs=0)
        assert m.arrived == m.served + m.dropped + m.shed \
            + len(m.final_queue_rids) + len(m.in_flight_rids)
        if paged:
            assert arena.free_pages == arena.total_pages
        runs.append(m)
        outputs.append(cexec.outputs)
    want, got = runs
    assert (got.preempted, got.resumed) == (want.preempted, want.resumed)
    assert got.preempted > 0 and got.resumed > 0
    assert _counts(got) == _counts(want)
    assert sorted(outputs[1]) == sorted(outputs[0])
    for rid, toks in outputs[0].items():
        np.testing.assert_array_equal(outputs[1][rid], toks)


def test_paged_two_engine_node_counts_match_jax():
    """``benchmarks/paged_vs_slab.py``'s two-engine node (BLOOM-3B and
    BLOOM-7B1 tiny engines, B = 8, s_max = n_max = 16, k = 2) served paged
    from an arena of 0.5x the slab pages at block_tokens 8, rate 16, under
    ``multi-dftsp``: the same served count, top-ups, allocation peak and
    blocks-in-use series."""
    hosted = ("bloom-3b", "bloom-7b1")
    dims = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                vocab=256)
    kw = dict(batch_capacity=8, s_max=16, n_max=16)
    pairs = {a: _pair(a, dims, kw) for a in hosted}
    epochs, rate = 8, 16.0
    runs, arenas = [], []
    for side, (menv_cls, penv, tag, replay, ka, ex, rt) in enumerate((
            (JMultiEnv, jpaper_env, jtagger, JReplay, jka.KVArena,
             jrt.EngineContinuousExecutor, jrt.ContinuousRuntime),
            (MultiLLMEnv, paper_env, random_tagger, ReplayGenerator,
             KVArena, EngineContinuousExecutor, ContinuousRuntime))):
        menv = menv_cls.host({m: penv(m, "W8A16") for m in hosted})
        engines = {a: p[side] for a, p in pairs.items()}
        arena = ka.for_engines(engines, block_tokens=8, shrink=0.5)
        traffic = replay.poisson(rate, (epochs - 1) * menv.T_E, seed=0,
                                 lengths=(4, 8, 16))
        m = rt(menv, "multi-dftsp", ex(engines, seed=0, arena=arena),
               k=2).run(gen=replay(traffic.requests), n_epochs=epochs,
                        seed=0, warmup_epochs=0,
                        tag_arrivals=tag(sorted(menv.envs), seed=0))
        assert m.arrived == m.served + m.dropped + m.shed \
            + len(m.final_queue_rids) + len(m.in_flight_rids)
        assert arena.free_pages == arena.total_pages    # drained
        runs.append(m)
        arenas.append(arena)
    want, got = (_counts(m) for m in runs)
    assert got == want
    assert arenas[1].alloc_peak == arenas[0].alloc_peak
    assert arenas[1].n_pages == arenas[0].n_pages
    assert got["topups"] > 0 and got["admitted_mid_epoch"] > 0


@pytest.mark.parametrize("spec", ["dftsp:quant=auto,split=true",
                                  "dftsp:quant=auto,calib=measured"])
def test_calibrated_policies_run(spec):
    """A policy that needs calibration calibrates on the engine at the start
    of the run, with the port's own ``quant.calibration``: a split policy
    gets a measured swap record, ``calib=measured`` measured methods (with
    measured weight alphas), and the run serves to its end with every
    request accounted for."""
    eng = _engine()
    rt = ContinuousRuntime(paper_env("bloom-3b", "W8A16"), spec,
                           EngineContinuousExecutor(eng, seed=0), k=2)
    m = rt.run(rate=4.0, n_epochs=2, seed=0, warmup_epochs=0)
    assert m.arrived == m.served + m.dropped + m.shed \
        + len(m.final_queue_rids) + len(m.in_flight_rids)
    assert m.served > 0
    if "split" in spec:
        rec = rt.policy._swap_record
        assert rec["backend"] == "cpu" and len(rec["pairs"]) == 12
        assert rt.policy._measured is None
    else:
        measured = rt.policy._measured
        assert set(measured) == {"W16A16", "W8A16", "W8A8", "W4A16-GPTQ",
                                 "W4A16-ZQL"}
        assert 0 < measured["W8A16"].alpha_w < 1
        assert rt.policy._swap_record is None
