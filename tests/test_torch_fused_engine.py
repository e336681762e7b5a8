"""The engine on the fused int8 decode tier: reduced float32 BLOOM-7B1
(d_head 128, so ``fusable_decode`` admits its int8 trees).

Within the port: the engine reports the fused tier at W8A16 and W8A8 and
the unfused one at W16A16 and W4A16 (and for BLOOM-3B, d_head 80);
``generate == generate_reference``, chunked decode (k in {1, 3, n_max})
equals ``generate``, and the paged path equals the slab path bit for bit,
through a refill and an eviction.  Against the JAX package, on the same
float32 weights, the greedy tokens at W8A16 are equal (the JAX engine
serves its dequantized tree on this CPU, through the unfused path; the
port takes the fused tier's plain version).
"""
from __future__ import annotations

import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import get_arch as jget_arch  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.engine import ServingEngine, tiny_engine  # noqa: E402
from repro_torch.serving.kv_arena import KVArena  # noqa: E402

DIMS = dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256,
            vocab=512, dtype="float32")
KW = dict(batch_capacity=4, s_max=16, n_max=8)
PROMPTS = [[5, 6, 7], [11, 2], [9, 9, 9, 9, 1], [3]]
CAPS = [8, 5, 8, 3]


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX engine, port engine) on the same float32 BLOOM-7B1 weights."""
    jcfg = jget_arch("bloom-7b1").scaled(**DIMS)
    je = jeng.ServingEngine(jcfg, seed=2, **KW)
    te = ServingEngine(get_arch("bloom-7b1").scaled(**DIMS),
                       params=bridge.from_jax_params(
                           jax.device_get(je._raw_params), device="cpu"),
                       device="cpu", **KW)
    return je, te


def assert_same(a, b):
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.lengths, b.lengths)


def test_decode_tier():
    _, te = _pair()
    assert te.cfg.d_head == 128
    assert te.decode_tier(8) == te.decode_tier((8, 8)) == "fused"
    assert te.decode_tier(0) == te.decode_tier(4) == "flash"
    small = tiny_engine("bloom-3b", device="cpu", quant_bits=8, **KW)
    assert small.decode_tier() == small.decode_tier((8, 8)) == "flash"


@pytest.mark.parametrize("bits", [8, (8, 8)], ids=["w8a16", "w8a8"])
def test_generate_equals_reference_on_the_fused_tier(bits):
    _, te = _pair()
    ops.reset_launch_counts()
    a = te.generate(PROMPTS, CAPS, quant_bits=bits)
    b = te.generate_reference(PROMPTS, CAPS, quant_bits=bits)
    assert_same(a, b)
    assert (a.lengths >= 1).all()
    assert not any(ops.launch_counts().values())      # the CPU: plain only


@pytest.mark.parametrize("k", [1, 3, KW["n_max"]])
@pytest.mark.parametrize("bits", [8, (8, 8)], ids=["w8a16", "w8a8"])
def test_chunked_equals_generate_on_the_fused_tier(bits, k):
    _, te = _pair()
    want = te.generate(PROMPTS, CAPS, quant_bits=bits)
    assert_same(te.generate_via_chunks(PROMPTS, CAPS, k=k, quant_bits=bits),
                want)
    arena = KVArena.for_engines(te, block_tokens=8)
    assert_same(te.generate_via_chunks(PROMPTS, CAPS, k=k, quant_bits=bits,
                                       arena=arena), want)
    assert arena.free_pages == arena.total_pages


def _drive(eng, st, k=3):
    while True:
        st = eng.generate_chunked(st, k)
        out, lengths, done, t = eng.poll_chunked(st)
        if eng.exhausted(lengths, done, st.caps_host, t):
            return st, out, lengths


@pytest.mark.parametrize("bits", [8, (8, 8)], ids=["w8a16", "w8a8"])
def test_paged_equals_slab_through_refill_and_eviction(bits):
    """A cohort started on two rows, one evicted at step 2, refilled into
    the freed slots at step 3: the paged path (through K7's plain version)
    gives the slab path's tokens (K6's) bit for bit."""
    _, te = _pair()
    runs = []
    for arena in (None, KVArena.for_engines(te, block_tokens=4)):
        st = te.start_chunked(PROMPTS[:2], CAPS[:2], quant_bits=bits,
                              arena=arena)
        st = te.generate_chunked(st, 2)
        st = te.evict_slots(st, [1])
        st = te.generate_chunked(st, 1)
        _, _, _, t = te.poll_chunked(st, False)
        st = te.refill_chunked(st, [1, 2, 3], PROMPTS[1:], CAPS[1:], t_now=t)
        st, out, lengths = _drive(te, st)
        if arena is not None:
            te.release_all(st)
            assert arena.free_pages == arena.total_pages
        runs.append((out, lengths))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert runs[0][1][2] > 0


def test_tokens_equal_jax_engine_at_w8a16():
    je, te = _pair()
    assert_same(te.generate(PROMPTS, CAPS, quant_bits=8),
                je.generate(PROMPTS, CAPS, quant_bits=8))
