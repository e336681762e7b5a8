"""One kept embedding table per engine for precisions that quantize the
embedding alike, on the CPU.

The port keeps the dequantized embedding table of a quantized tree
(``QTensor.dense``): the embedding gather and the tied unembedding read it
every step.  W8A16 and W8A8 quantize every weight to the same int8 values
and scales, so the engine makes the W8A8 tree from the W8A16 one
(``params_for``, ``ptq.with_act_bits``): the same q, scales and table, in
whichever order the two are asked for; W4A16's table differs and is its
own.  The sharing changes no value: logits and greedy
tokens at both precisions equal those of freshly quantized trees, and
``tree_bytes`` (which counts neither table) equals the JAX package's on the
same weights.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax  # noqa: E402
import numpy as np  # noqa: E402

from conftest import REDUCTIONS, reduced_cfg  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.quant import ptq as jptq  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.quant import ptq as tptq  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ENGINE_KW = dict(batch_capacity=2, s_max=16, n_max=6, device="cpu")


def _engine():
    """A reduced float32 BLOOM engine on the JAX package's weights (W8),
    and those weights as the JAX tree."""
    jcfg = reduced_cfg("bloom-3b").scaled(dtype="float32")
    p = jtr.init_params(jcfg, jax.random.key(0))
    tcfg = get_arch("bloom-3b").scaled(**REDUCTIONS["bloom-3b"],
                                       dtype="float32")
    tp = bridge.from_jax_params(jax.device_get(p), device="cpu")
    return ServingEngine(tcfg, params=tp, quant_bits=8, **ENGINE_KW), p


def _prompts(engine):
    rng = np.random.default_rng(0)
    return [rng.integers(1, engine.cfg.vocab, size=n).tolist()
            for n in (5, 16)]


def test_w8a16_and_w8a8_share_one_table():
    engine, p = _engine()
    prompts = _prompts(engine)
    runs = {}
    for bits in (8, (8, 8)):
        runs[bits] = engine.generate(prompts, [6, 6], quant_bits=bits)
    tables = engine.kept_tables()
    assert set(tables) == {8, (8, 8)}
    assert tables[8] is tables[(8, 8)]
    assert tables[8].untyped_storage().data_ptr() == \
        engine.params_for((8, 8))["embed"].dense().untyped_storage() \
        .data_ptr()
    # W4A16 quantizes the embedding to other values: its own table
    engine.params_for(4)["embed"].dense()
    tables = engine.kept_tables()
    assert tables[4] is not tables[8]
    assert not torch.equal(tables[4], tables[8])
    # tree_bytes counts neither table and equals the JAX package's
    for bits, (w, a) in ((8, (8, 16)), ((8, 8), (8, 8)), (4, (4, 16))):
        assert tptq.tree_bytes(engine.params_for(bits)) == \
            jptq.tree_bytes(jptq.quantize_tree(p, w, act_bits=a))
    # the tokens of each precision equal those of a fresh engine that never
    # served the other one
    for bits in (8, (8, 8)):
        fresh, _ = _engine()
        want = fresh.generate(prompts, [6, 6], quant_bits=bits)
        np.testing.assert_array_equal(runs[bits].tokens, want.tokens)
        np.testing.assert_array_equal(runs[bits].lengths, want.lengths)


@pytest.mark.parametrize("bits,act_bits", [(8, 16), (8, 8)])
def test_shared_table_leaves_logits_unchanged(bits, act_bits):
    """Prefill and one decode step on the engine's cached tree (whose table
    may be the other precision's) give the logits of a freshly quantized
    tree with its own table, bit for bit."""
    engine, _ = _engine()
    for b in (8, (8, 8)):
        engine.params_for(b)["embed"].dense()
    spec = bits if act_bits == 16 else (bits, act_bits)
    cached = engine.params_for(spec)
    fresh = tptq.quantize_tree(engine._raw_params, bits, act_bits=act_bits)
    assert fresh["embed"]._dense is None
    tokens = torch.from_numpy(engine.pad_prompts(_prompts(engine)))
    outs = []
    for params in (cached, fresh):
        logits, cache = engine.model.prefill(params, {"tokens": tokens},
                                             engine.cache_len)
        cur = torch.argmax(logits[..., :engine.cfg.vocab], -1)
        step, _ = engine.model.decode_step(params, cache, cur[:, None],
                                           engine.s_max, use_kernel=True)
        outs.append((logits, step))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("first", [8, (8, 8)])
def test_w8a8_tree_holds_no_second_copy(first):
    """Whichever precision is asked for first, every quantized leaf of the
    W8A8 tree is tagged for int8 activations over the W8A16 leaf's own q
    and scale, every other leaf is the same tensor, and the values equal a
    fresh ``quantize_tree`` at act_bits 8."""
    engine, _ = _engine()
    engine.params_for(first)
    a16, a8 = engine.params_for(8), engine.params_for((8, 8))
    assert engine.kept_tables()[8] is engine.kept_tables()[(8, 8)]
    fresh = tptq.tree_leaves(tptq.quantize_tree(engine._raw_params, 8,
                                                act_bits=8))
    leaves = list(zip(tptq.tree_leaves(a16), tptq.tree_leaves(a8), fresh))
    assert sum(isinstance(l, tptq.QTensor) for l, _, _ in leaves) > 1
    for l16, l8, want in leaves:
        if isinstance(l16, tptq.QTensor):
            assert (l16.act_bits, l8.act_bits) == (16, 8)
            assert l8.q is l16.q and l8.scale is l16.scale
            assert (l8.bits, l8.shape, l8.dtype) == \
                (want.bits, want.shape, want.dtype)
            assert torch.equal(l8.q, want.q)
            assert torch.equal(l8.scale, want.scale)
        else:
            assert l8 is l16
            assert torch.equal(l8, want)

