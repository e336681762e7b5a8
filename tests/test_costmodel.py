"""Cost-model fidelity: the paper's §II-B equations reproduced exactly for
MHA dense archs, and the per-family generalizations' invariants."""
from __future__ import annotations

import pytest

from repro.config import get_arch
from repro.core.costmodel import PARAM_BYTES, CostModel


def paper_m1(c):
    return c.n_layers * (8 * c.d_model * c.d_head * c.n_heads
                         + 4 * c.d_model * c.d_ff)


def paper_t_prefill_flops(c, s, batch):
    return batch * c.n_layers * (6 * s * c.d_model ** 2
                                 + 4 * s * s * c.d_model
                                 + 2 * s * c.d_model ** 2
                                 + 4 * s * c.d_model * c.d_ff)


def paper_t_decode_flops(c, s, ns):
    total = 0.0
    for n in ns:
        total += c.n_layers * (n - 1) * (
            6 * c.d_model ** 2 + 4 * (s + n / 2) * c.d_model
            + 2 * c.d_model ** 2 + 4 * c.d_model * c.d_ff)
    return total


@pytest.mark.parametrize("arch", ["bloom-3b", "bloom-7b1", "opt-13b"])
def test_paper_equations_exact_for_mha_dense(arch):
    c = get_arch(arch)
    cm = CostModel(c, paper_faithful=True)
    assert cm.weight_bytes() == pytest.approx(paper_m1(c))
    assert cm.prefill_flops(512, 4) == pytest.approx(
        paper_t_prefill_flops(c, 512, 4))
    assert cm.decode_flops(512, [128, 256]) == pytest.approx(
        paper_t_decode_flops(c, 512, [128, 256]))


@pytest.mark.parametrize("arch", ["bloom-3b", "opt-13b"])
def test_paper_kv_cache_equations(arch):
    c = get_arch(arch)
    cm = CostModel(c, paper_faithful=True)
    # m2_I = 4 L s' dm * batch   (2 bytes x (K+V) = 4)
    assert cm.kv_bytes_prefill(512, 3) == pytest.approx(
        4 * c.n_layers * 512 * c.n_kv_heads * c.d_head * 3)
    # m2_A = 4 L n dm
    assert cm.kv_bytes_decode([256]) == pytest.approx(
        4 * c.n_layers * 256 * c.n_kv_heads * c.d_head)


def test_gqa_cache_smaller_than_mha():
    c = get_arch("qwen3-1.7b")           # 16 q heads, 8 kv heads
    cm = CostModel(c)
    mha = CostModel(c.scaled(n_kv_heads=c.n_heads))
    assert cm.kv_bytes_prefill(512, 1) == pytest.approx(
        mha.kv_bytes_prefill(512, 1) * c.n_kv_heads / c.n_heads)


def test_ssm_decode_memory_is_context_free():
    c = get_arch("xlstm-1.3b")
    cm = CostModel(c)
    assert cm.kv_bytes_decode([128]) == 0.0
    assert cm.state_bytes() > 0
    # prefill footprint must not grow with s
    assert cm.kv_bytes_prefill(512, 1) == cm.kv_bytes_prefill(32768, 1)


def test_ssm_decode_flops_linear_in_n():
    cm = CostModel(get_arch("xlstm-1.3b"))
    f1 = cm.decode_flops(512, [101])
    f2 = cm.decode_flops(512, [201])
    # (n-1) scaling exactly linear (no quadratic attention-read term)
    assert f2 / f1 == pytest.approx(200 / 100, rel=1e-6)
    assert not cm.latency_is_quadratic()


def test_dense_decode_flops_superlinear_in_n():
    cm = CostModel(get_arch("olmo-1b"))
    f1 = cm.decode_flops(512, [101])
    f2 = cm.decode_flops(512, [201])
    assert f2 > 2.0 * f1
    assert cm.latency_is_quadratic()


def test_sliding_window_caps_cache():
    c = get_arch("mixtral-8x22b")        # SWA 4096
    cm = CostModel(c)
    assert c.sliding_window == 4096
    assert cm.kv_bytes_prefill(32768, 1) == cm.kv_bytes_prefill(4096, 1)
    # decode from a full-window prompt adds nothing
    assert cm.kv_bytes_decode([256], s=8192) == 0.0


def test_moe_flops_count_active_only():
    c = get_arch("mixtral-8x22b")
    cm = CostModel(c)
    dense_equiv = CostModel(c.scaled(
        moe=type(c.moe)(n_experts=0, top_k=0)))
    # top-2-of-8 FFN ~= 2x the dense FFN cost (+ router), never 8x
    assert cm._ffn_flops_per_token() < 2.1 * dense_equiv._ffn_flops_per_token()
    assert cm._ffn_flops_per_token() > 1.9 * dense_equiv._ffn_flops_per_token()


def test_moe_weights_count_all_experts():
    c = get_arch("granite-moe-1b-a400m")
    assert c.param_count() > 3 * c.active_param_count()


def test_hybrid_cache_counts_shared_sites_only():
    c = get_arch("zamba2-7b")
    cm = CostModel(c)
    n_sites = c.n_layers // c.hybrid.attn_every
    per_tok = 2 * PARAM_BYTES * n_sites * c.n_kv_heads * c.d_head
    assert cm._kv_bytes_per_token() == pytest.approx(per_tok)


def test_encdec_prefill_includes_encoder():
    c = get_arch("whisper-tiny")
    cm = CostModel(c)
    dec_only = CostModel(c.scaled(encdec=None, family="dense"))
    assert cm.prefill_flops(64, 1) > dec_only.prefill_flops(64, 1)


# -- the port's cost model of the published Zamba2 block -----------------------

def _zamba2_published_hand():
    """Zamba2-7B-Instruct counted by hand from its config.json: the 81
    Mamba2 layers (in_proj to z | xBC | dt, the conv's taps and bias,
    A_log, D, dt_bias, the gate norm, out_proj, the pre-norm), the two
    shared blocks (q, k, v from the 7168-wide concatenation, o_proj, the
    GeGLU's gate, up and down, two norms), the 13 sites' adapters and
    linears, the tied embedding and the final norm."""
    D, di, C, H, F = 3584, 7168, 7168 + 2 * 2 * 64, 112, 14336
    mamba = D * (di + C + H) + 4 * C + C + 3 * H + di + di * D + D
    block = 3 * 2 * D * 7168 + 7168 * D + 3 * D * F + 2 * D + D
    site = 128 * (D + 2 * F) + D * D
    return 81 * mamba + 2 * block + 13 * site + 32000 * D + D


def test_port_prices_published_zamba2_from_its_fields():
    from repro_torch.config import get_arch as port_arch
    from repro_torch.core.costmodel import CostModel as PortCostModel
    c = port_arch("zamba2-7b-instruct")
    cm = PortCostModel(c)
    hand = _zamba2_published_hand()
    assert c.param_count() == hand
    assert hand == pytest.approx(7.36e9, rel=1e-3)
    assert cm.weight_bytes() == 2 * hand
    # float32 SSM state: 81 layers x 14.68 MB at B = 8
    assert 8 * cm.state_bytes() == 81 * 8 * 112 * 64 * 64 * 4
    assert 8 * 112 * 64 * 64 * 4 == pytest.approx(14.68e6, rel=1e-3)
    # the 13 sites' bf16 k, v of 32 heads of 224
    assert cm.kv_bytes_prefill(512, 1) == pytest.approx(
        13 * 2 * 2 * 32 * 224 * 512 + cm.state_bytes())
    ssm = 2 * (3584 * (2 * 7168 + 2 * 2 * 64 + 112) + 7168 * 3584) \
        + 4 * 112 * 64 * 64
    s, n = 512, 128
    ctx = s + n / 2
    site = (2 * 7168 * 3 * 7168 + 2 * 7168 * 3584 + 4 * ctx * 32 * 224
            + 3 * 2 * 3584 * 14336 + 2 * 128 * (3584 + 28672)
            + 2 * 3584 * 3584)
    assert cm.decode_flops(s, [n]) == pytest.approx(
        (n - 1) * (81 * ssm + 13 * site), rel=1e-12)


def test_port_prices_zamba2_simplification_as_before():
    """The JAX package's simplification (``zamba2-7b``) keeps the port's
    numbers of before the published block came in."""
    from repro_torch.config import get_arch as port_arch
    from repro_torch.core.costmodel import CostModel as PortCostModel
    cm = PortCostModel(port_arch("zamba2-7b"))
    assert cm.weight_bytes() == 13_499_298_240.0
    assert cm.state_bytes() == 148_635_648
    assert cm.kv_bytes_decode([1]) == 186_368.0
    assert cm.prefill_flops(512, 8) == 74_402_704_130_048.0
    assert cm.decode_flops(512, [128] * 8) == 18_515_855_540_224.0
