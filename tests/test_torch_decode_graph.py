"""The port's decode loop with its position and early exit on the device.

Against the JAX package, on the same float32 weights (through
``repro_torch.bridge``): with an ``eos_id`` that every row emits early,
``poll_chunked`` returns the JAX package's ``(out, lengths, done, t)`` after
every segment, slab and paged, for k in {1, 3, 16, n_max}: ``t`` is the
step where the loop stopped, not the segment's end.

Within the port, on the kernels' plain versions: a decode step whose
position is an int32 tensor on the device is bitwise equal to the step a
host int drove before (the host-int formulation is kept as the oracle in
``tests/test_torch_cuda.py``, which runs the same cases on the card:
Python-int cache slots, valid counts and rope angles), on every tier of
reduced BLOOM-3B (K1 + K4, K2 + K4, K3 + K4 plain) and the fused tier of
reduced BLOOM-7B1 (K6 / K7 plain, a16 and a8), at float32 and bfloat16,
slab and paged (K5, K7), at positions 0, s_max, W - 1 and, on the slab, W
and W + 7 (the fused tier's eviction slot); the eager step body equals
the host-int segment loop it replaced, token for token, through forced
replay and a refill; the loop's tensors keep their addresses through
refill, eviction and a table re-ship; and the launch counters add one
step's launches per iteration a device loop reports (a stand-in for the
loop object: this CPU has no graph).
"""
from __future__ import annotations

import copy
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import get_arch as jget_arch  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import kv_arena as jka  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_loop import DeviceLoop  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.kv_arena import KVArena  # noqa: E402
from test_torch_cuda import (POSITIONS, TIERS,  # noqa: E402
                             check_device_position_step,
                             check_paged_device_position_step)

KW = dict(batch_capacity=4, s_max=24, n_max=8)
DIMS = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
            vocab=256)


@functools.lru_cache(maxsize=None)
def _pair(eos_id: int = 0):
    """(JAX engine, port engine) on the same float32 BLOOM-3B weights."""
    jcfg = jget_arch("bloom-3b").scaled(**DIMS, dtype="float32")
    je = jeng.ServingEngine(jcfg, seed=5, eos_id=eos_id, **KW)
    te = ServingEngine(get_arch("bloom-3b").scaled(**DIMS, dtype="float32"),
                       params=bridge.from_jax_params(
                           jax.device_get(je._raw_params), device="cpu"),
                       device="cpu", eos_id=eos_id, **KW)
    return je, te


@functools.lru_cache(maxsize=None)
def _early_eos():
    """Prompts, caps and an ``eos_id`` that every row emits within its
    first half of n_max tokens (a token of every row's early stream, found
    on the oracle with no EOS in play)."""
    _, te = _pair()
    rng = np.random.default_rng(0)
    half = KW["n_max"] // 2
    for _ in range(200):
        prompts = [rng.integers(1, 256, size=n).tolist() for n in (3, 5, 2)]
        ref = te.generate_reference(prompts, [KW["n_max"]] * 3)
        common = set.intersection(*(set(r[:half].tolist())
                                    for r in ref.tokens))
        if common - {0}:
            return prompts, [KW["n_max"]] * 3, min(common - {0})
    raise AssertionError("no token every row emits early")


@pytest.mark.parametrize("k", [1, 3, 16, 8])
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_poll_equals_reference_with_early_eos(paged, k):
    prompts, caps, eos = _early_eos()
    je, te = _pair(eos)
    arenas = (jka.KVArena.for_engines(je, block_tokens=8),
              KVArena.for_engines(te, block_tokens=8)) if paged \
        else (None, None)
    states = [eng.start_chunked(prompts, caps, arena=a)
              for eng, a in zip((je, te), arenas)]
    for _ in range(-(-KW["n_max"] // k) + 1):
        states = [eng.generate_chunked(st, k)
                  for eng, st in zip((je, te), states)]
        want, got = (eng.poll_chunked(st)
                     for eng, st in zip((je, te), states))
        for a, b in zip(want[:3], got[:3]):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        assert got[3] == want[3]
    assert want[3] < KW["n_max"]                 # the loop stopped early
    assert (got[2][:3]).all()                    # every row saw the EOS
    for eng, st, a in zip((je, te), states, arenas):
        if a is not None:
            eng.release_all(st)


# -- the device position: bitwise the host-int step -------------------------
# The oracle and the checks are shared with the card's run of the same
# cases (tests/test_torch_cuda.py, which imports no JAX).


@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,bits", TIERS)
def test_device_position_step_is_bitwise_the_host_int_step(arch, bits, dtype,
                                                           pos):
    check_device_position_step(arch, bits, dtype, pos, "cpu")


@pytest.mark.parametrize("pos", POSITIONS[:3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,bits", TIERS)
def test_paged_device_position_step_is_bitwise_the_slab_host_int_step(
        arch, bits, dtype, pos):
    check_paged_device_position_step(arch, bits, dtype, pos, "cpu")


def test_rope_rows_round_alike_from_an_int_and_a_tensor():
    for pos in (0, 1, 511, 576, 639, 647, 4095, 65535):
        a = ops._rope_rows(pos, 128, 1e4, "cpu")
        b = ops._rope_rows(torch.tensor(pos, dtype=torch.int32), 128, 1e4,
                           "cpu")
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# -- the step body --------------------------------------------------------


def _host_int_segment(eng, state, t_end: int):
    """The eager segment loop the step body replaced: ``t_end - t`` masked
    steps at host-int positions."""
    cur, out, lengths, done = (state.cur.clone(), state.out.clone(),
                               state.lengths.clone(), state.done.clone())
    params = eng.params_for(state.bits)
    for t in range(state.t, t_end):
        alive = (~done) & (lengths < state.caps)
        idx = torch.clamp(lengths, max=eng.n_max - 1)[:, None]
        cur = torch.where(lengths < state.n_forced,
                          torch.gather(state.forced, 1, idx)[:, 0]
                          .to(cur.dtype), cur)
        out.scatter_(1, idx, torch.where(
            alive, cur, torch.gather(out, 1, idx)[:, 0])[:, None])
        lengths = lengths + alive
        done = done | ((cur == eng.eos_id) & alive)
        logits, _ = eng.model.decode_step(params, state.cache, cur[:, None],
                                          eng.s_max + t)
        cur = torch.argmax(logits[..., :eng.cfg.vocab], -1)
    return cur, out, lengths, done


@pytest.mark.parametrize("bits", [0, 8, (8, 8), 4])
def test_step_body_equals_the_host_int_segment(bits):
    _, te = _pair()
    prompts = [[5, 6, 7], [9, 9, 1], [3]]
    st = te.start_chunked(prompts, [8, 3, 6], quant_bits=bits,
                          prefixes=[None, [4, 4], None])
    for k in (2, 3, 8):
        ref_state = copy.deepcopy(st)
        want = _host_int_segment(te, ref_state, min(st.t + k, te.n_max))
        st = te.generate_chunked(st, k)
        for a, b in zip(want, (st.cur, st.out, st.lengths, st.done)):
            assert torch.equal(a, b)
        if k == 2:
            _, _, _, t = te.poll_chunked(st)
            st = te.refill_chunked(st, [3], [[7, 7]], [4], t_now=t)


# -- fixed addresses -------------------------------------------------------


def _addresses(st):
    ptrs = {name: getattr(st, name).data_ptr() for name in (
        "cur", "out", "lengths", "done", "caps", "forced", "n_forced",
        "t_dev", "t_end")}
    if hasattr(st, "cache"):
        ptrs["cache"] = [layer[n].data_ptr() for layer in st.cache
                         for n in layer]
    else:
        ptrs["table"] = st.table.device.data_ptr()
        ptrs["pages"] = [leaf.data_ptr() for leaf in st.arena.buffers()
                         .values()]
    return ptrs


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_loop_tensors_keep_their_addresses(paged):
    _, te = _pair()
    arena = KVArena.for_engines(te, block_tokens=8) if paged else None
    st = te.start_chunked([[5, 6, 7], [9, 9, 1], [3]], [8, 2, 8],
                          arena=arena, prefixes=[None, [4], None])
    st = te.generate_chunked(st, 3)
    ptrs = _addresses(st)
    _, lengths, done, t = te.poll_chunked(st)
    assert lengths[1] == 2
    if paged:
        st = te.release_slots(st, [1])            # a table row changed
    st = te.evict_slots(st, [0])
    st = te.refill_chunked(st, [1, 3], [[9, 9, 9], [1, 2]], [8, 3],
                           t_now=t)
    table = st.table.device if paged else None    # re-shipped, in place
    st = te.generate_chunked(st, 4)               # a top-up, another ship
    assert _addresses(st) == ptrs
    if paged:
        assert st.table.device is table
        np.testing.assert_array_equal(st.table.device.numpy(),
                                      st.table.host)
        te.release_all(st)


def test_generate_keeps_one_loop():
    _, te = _pair()
    te.generate([[5, 6, 7]], [8])
    loop = te._gen
    ptrs = _addresses(loop)
    for bits in (0, 8):
        te.generate([[1, 2], [3, 4, 5]], [4, 8], quant_bits=bits)
    assert te._gen is loop and _addresses(loop) == ptrs


# -- launch counts ---------------------------------------------------------


class _StandInLoop(DeviceLoop):
    """A device loop without a device: its iteration count is set by hand
    (this CPU has no graph to launch)."""

    def __init__(self, launches):          # noqa: D107 (no CUDA build)
        self.launches = dict(launches)
        self.iters = torch.zeros((), dtype=torch.int64)
        self.counted = 0


def test_launch_counts_add_one_step_per_iteration():
    _, te = _pair()
    st = te.start_chunked([[5, 6, 7]], [8])
    per_step = {"w8a16": 6, "w8a16_gemv": 6, "flash_decode": 1}
    st.graphs[st.bits] = loop = _StandInLoop(per_step)
    ops.reset_launch_counts()
    for iters, want in ((5, 5), (5, 5), (7, 7), (12, 12)):
        loop.iters.fill_(iters)
        te.poll_chunked(st, with_tokens=iters % 2 == 0)
        counts = ops.launch_counts()
        assert {k: counts[k] for k in per_step} == \
            {k: v * want for k, v in per_step.items()}
        assert sum(counts.values()) == want * sum(per_step.values())
    # generate reads its loop's count back in its one copy too
    te.generate([[5, 6, 7]], [8])
    te._gen.graphs[0] = gen_loop = _StandInLoop({"flash_decode": 1})
    gen_loop.iters.fill_(3)
    ops.reset_launch_counts()
    te.generate([[5, 6, 7]], [8])
    assert ops.launch_counts()["flash_decode"] == 3
    del te._gen.graphs[0]
