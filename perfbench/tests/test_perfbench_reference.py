"""The float32 reference against the serving program's CPU forward, on
reduced configurations; the costs' formulas against direct counts.

The reference imports nothing of the program; these tests import both.
At float32, weights kept or quantized alike on both sides, the two
agree to rounding: logits within 1e-4, and every served token at most
1e-4 below the reference's best logit, also for a row admitted into a
running cohort (the zero key slots of its gap)."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.costs import k1_gemv, k4, k5, k6, qmm_tc  # noqa: E402
from perfbench.harness.check import served_gaps  # noqa: E402
from perfbench.reference import bloom  # noqa: E402
from perfbench.reference.bloom import (fake_quant, forward_rows,  # noqa
                                       make_params, pad_left)

torch.set_num_threads(1)

MODEL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
             d_ff=256, vocab=512, norm="layernorm", act="gelu",
             tie_embeddings=True, rope_theta=10000.0, dtype="float32")


def _cfg():
    from perfbench.harness.runner import port_config
    return port_config(bloom, MODEL, "bloom-3b", reduced=True)


@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_is_the_programs_quantization(bits):
    from repro_torch.quant.ptq import dequantize, quantize
    w = torch.randn(48, 40, generator=torch.Generator().manual_seed(bits))
    assert torch.equal(fake_quant(w, bits), dequantize(quantize(w, bits)))


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_reference_logits_match_the_program_forward(seed):
    from repro_torch.models import transformer
    params = make_params(MODEL, seed, "cpu")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 512, size=(2, 24))
    got = transformer.forward(_cfg(), params,
                              {"tokens": torch.from_numpy(tokens)})
    rows = [dict(prompt=t[:16], gap=0, fed=t[16:], bits=0) for t in tokens]
    ref = forward_rows(params, MODEL, 16, rows)
    for b in range(2):
        torch.testing.assert_close(ref[b], got[b, 15:, :512], rtol=1e-4,
                                   atol=1e-4)


def test_reference_lays_out_prompts_as_served():
    """The reference pads and truncates a raw prompt as the serving
    program lays it out: its last s_max tokens, right-aligned, token 0
    before them."""
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(_cfg(), params=make_params(MODEL, 1, "cpu"),
                        batch_capacity=3, s_max=16, n_max=4, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (5, 16, 23)]
    served = eng.pad_prompts(prompts)
    for i, p in enumerate(prompts):
        assert np.array_equal(pad_left(p, 16).numpy(), served[i])


def test_served_tokens_agree_slab_and_refill():
    """The engine's tokens at float32 / W8 on the CPU: a cohort started
    with two rows, a third refilled at cohort step 4 (gap 4), all run to
    their caps; every served token is the reference's best to 1e-4."""
    from repro_torch.serving.engine import ServingEngine
    params = make_params(MODEL, 7, "cpu")
    eng = ServingEngine(_cfg(), params=params, batch_capacity=4, s_max=16,
                        n_max=12, quant_bits=8, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (16, 9, 13)]
    st = eng.start_chunked(prompts[:2], [12, 12])
    st = eng.generate_chunked(st, 4)
    _, _, _, t = eng.poll_chunked(st)
    assert t == 4
    st = eng.refill_chunked(st, [2], [prompts[2]], [12], t_now=t)
    for _ in range(3):
        st = eng.generate_chunked(st, 4)
    out, lengths, _, _ = eng.poll_chunked(st)
    rows = [dict(prompt=prompts[i], gap=g, tokens=out[slot, :lengths[slot]],
                 bits=8)
            for i, (slot, g) in enumerate([(0, 0), (1, 0), (2, 4)])]
    assert [len(r["tokens"]) for r in rows] == [12, 12, 8]
    gaps = served_gaps(bloom, params, MODEL, 16, rows, device="cpu")
    assert max(float(g.max()) for g in gaps) <= 1e-4
    slab = eng.generate(prompts[:2], [12, 12])
    assert np.array_equal(slab.tokens, out[:2, :12])


def _direct_mm(M, K, N):
    x = torch.zeros(M, K, dtype=torch.bfloat16)
    q = torch.zeros(K, N, dtype=torch.int8)
    s = torch.zeros(N, dtype=torch.float32)
    o = torch.zeros(M, N, dtype=torch.bfloat16)
    with FlopCounterMode(display=False) as fc:
        x.float() @ q.float()
    return fc.get_total_flops(), sum(t.nbytes for t in (x, q, s, o))


@pytest.mark.parametrize("mod", [k1_gemv, qmm_tc])
def test_matmul_costs(mod):
    assert mod.cost(8, 48, 40) == _direct_mm(8, 48, 40)


def _direct_attention(B, nh, nkv, dh, nv):
    q = torch.zeros(B, nh, dh, dtype=torch.bfloat16)
    k = torch.zeros(B, nv, nkv, dh, dtype=torch.bfloat16)
    with FlopCounterMode(display=False) as fc:
        s = torch.einsum("bhd,bshd->bhs", q.float(), k.float())
        torch.einsum("bhs,bshd->bhd", s, k.float())
    nbytes = 2 * k.nbytes + 2 * q.nbytes + 4 * B
    return fc.get_total_flops(), nbytes


def test_attention_costs():
    assert k4.cost(2, 4, 4, 16, 37) == _direct_attention(2, 4, 4, 16, 37)
    ops, nb = _direct_attention(2, 4, 4, 16, 37)
    assert k5.cost(2, 4, 4, 16, 37, 5) == (ops, nb + 4 * 2 * 5)


def test_fused_costs():
    B, D, nh, dh, nv = 2, 64, 4, 16, 9
    ws = [torch.zeros(D, nh * dh, dtype=torch.int8) for _ in range(3)] \
        + [torch.zeros(nh * dh, D, dtype=torch.int8)]
    scales = [torch.zeros(w.shape[1]) for w in ws]
    x = torch.zeros(B, D, dtype=torch.bfloat16)
    with FlopCounterMode(display=False) as fc:
        for w in ws:
            (torch.zeros(B, w.shape[0]) @ w.float())
    ops_att, kv_bytes = _direct_attention(B, nh, nh, dh, nv + 1)
    inputs = sum(t.nbytes for t in ws + scales) + x.nbytes \
        + 2 * B * nv * nh * dh * 2 + 2 * (dh // 2) * 4
    outputs = x.nbytes + 2 * B * nh * dh * 2 + 2 * B * 4
    assert k6.cost(B, D, nh, nh, dh, nv) == (fc.get_total_flops() + ops_att,
                                             inputs + outputs)


def test_model_flops_by_count():
    m = dict(MODEL, n_layers=1)
    D, F, V = 64, 256, 512
    per = 2 * (4 * D * D + 2 * D * F)
    s, n = 5, 4
    want = s * per + 4 * 64 * sum(range(1, s + 1)) + 2 * D * V
    want += (n - 1) * (per + 2 * D * V) + 4 * 64 * sum(s + j
                                                      for j in range(1, n))
    assert bloom.request_flops(m, s, n) == want
    assert bloom.tokens_flops(m, s, 0, 2) \
        + bloom.tokens_flops(m, s, 2, n) == \
        bloom.decode_flops(m, s, n)
