"""The published Zamba2 block (``zamba2-7b-instruct``, ``models/zamba.py``'s
published layout) against its plain float32 reference
(``perfbench/reference/zamba2.py``) and against ``transformers``'
``Zamba2ForCausalLM``, on the CPU at a small size.

The small model keeps every kind of part: 9 Mamba2 layers with sites
before layers 2, 5 and 8 (blocks A, B, A), two B/C groups, a conv bias,
a chunk of 4 over a 10-token prompt (so the chunked scan runs over
several chunks and a padded last chunk), and 32-wide heads over the
128-wide concatenation.  Weights come from the reference's own draw.

Tolerances, float32 on both sides (logits about 0.7 in magnitude at
this size):

- ``TOL`` = 2e-5 between the program's prefill + decode through its
  caches and the reference's full forward: the two sum in other orders
  (the chunked scan against the step-by-step recurrence, the blocked
  attention and the cache's masked softmax against one causal softmax),
  which read at most 1.2e-6 on the seeds below; a bf16 model, or a
  term left out (the conv bias, the D skip, an adapter), reads 1e-3 or
  more.
- ``HF_TOL`` = 2e-5 against ``transformers`` for the same reasons (its
  scan, over one chunk, sums in its own order).
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

from repro_torch.config import get_arch  # noqa: E402
from repro_torch.models import zamba  # noqa: E402

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "zamba2_reference", ROOT / "perfbench" / "reference" / "zamba2.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

SITES = [2, 5, 8]
MODEL = dict(n_layers=9, d_model=64, n_heads=4, n_kv_heads=4, d_head=32,
             d_ff=96, vocab=256, norm="rmsnorm", act="geglu",
             tie_embeddings=True, rope_theta=10000.0,
             dtype="float32",
             ssm=dict(d_state=8, head_dim=16, expand=2, chunk=4,
                      conv_width=4, n_groups=2, conv_bias=True),
             hybrid=dict(sites=SITES, adapter_rank=4))
S_MAX, N_FED = 10, 6
TOL = 2e-5
HF_TOL = 2e-5
SEEDS = [2 ** 31 + 5, 3_000_000_019, 7]


def _cfg(model=MODEL):
    return ref.scaled_program(get_arch("zamba2-7b-instruct"), model)


def _tokens(seed, n=S_MAX + N_FED, batch=2):
    g = torch.Generator().manual_seed(seed % (2 ** 31))
    return torch.randint(1, MODEL["vocab"], (batch, n), generator=g)


def _reference(params, tok, bits=0):
    rows = [dict(prompt=t[:S_MAX].tolist(), gap=0, fed=t[S_MAX:].tolist(),
                 bits=bits) for t in tok]
    return torch.stack(ref.forward_rows(params, MODEL, S_MAX, rows, "cpu"))


@torch.no_grad()
def _served(cfg, params, tok):
    """The program's logits at the last prompt position (prefill) and at
    each fed token (decode steps through the caches)."""
    logits, cache = zamba.prefill(cfg, params, {"tokens": tok[:, :S_MAX]},
                                  cache_len=S_MAX + N_FED)
    out = [logits]
    for j in range(N_FED):
        logits, cache = zamba.decode_step(cfg, params, cache,
                                          tok[:, S_MAX + j:S_MAX + j + 1],
                                          S_MAX + j)
        out.append(logits)
    return torch.stack(out, 1)[..., :MODEL["vocab"]]


def test_config_is_the_published_one():
    cfg = get_arch("zamba2-7b-instruct")
    assert (cfg.n_layers, cfg.d_model, cfg.d_head, cfg.d_ff, cfg.vocab) == \
        (81, 3584, 224, 14336, 32000)
    assert cfg.hybrid.sites == (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65,
                                71, 77)
    assert (cfg.ssm.n_groups, cfg.ssm.chunk, cfg.ssm.conv_bias) == \
        (2, 256, True)
    assert zamba._attn_scale(cfg) == (224 / 2) ** -0.5
    assert ref.program_sizes(cfg) == ref.file_sizes(
        __import__("json").loads((ROOT / "perfbench/configs/"
                                  "zamba2-7b-instruct.json").read_text())
        ["model"])


@pytest.mark.parametrize("seed", SEEDS)
def test_prefill_and_decode_match_the_full_forward(seed):
    cfg = _cfg()
    params = ref.make_params(MODEL, seed, "cpu")
    tok = _tokens(seed)
    want = _reference(params, tok)
    got = _served(cfg, params, tok)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)
    full = zamba.forward(cfg, params, {"tokens": tok})[..., :MODEL["vocab"]]
    torch.testing.assert_close(full[:, S_MAX - 1:], want, rtol=0, atol=TOL)


def _drop(params, key):
    for lp in params["mamba"]:
        if key == "conv_b":
            lp["conv_b"] = torch.zeros_like(lp["conv_b"])
        elif key == "D":
            lp["D"] = torch.zeros_like(lp["D"])
    if key == "adapter":
        for sp in params["sites"]:
            sp["lora_b"] = torch.zeros_like(sp["lora_b"])
    return params


@pytest.mark.parametrize("variant", ["bf16", "conv_b", "D", "adapter"])
def test_lower_precision_or_dropped_term_fails_the_tolerance(variant):
    """A bf16 model, or the program with one term left out, lies beyond
    ``TOL`` of the reference."""
    seed = SEEDS[0]
    params = ref.make_params(MODEL, seed, "cpu")
    tok = _tokens(seed)
    want = _reference(params, tok)
    if variant == "bf16":
        model = dict(MODEL, dtype="bfloat16")
        got = _served(_cfg(model), ref.make_params(model, seed, "cpu"), tok)
    else:
        got = _served(_cfg(), _drop(ref.make_params(MODEL, seed, "cpu"),
                                    variant), tok)
    assert float((got.float() - want).abs().max()) > 50 * TOL


@pytest.mark.parametrize("change", ["block_order", "adapter_index",
                                    "concat_embed"])
def test_block_order_adapter_index_and_embedding_each_matter(change,
                                                             monkeypatch):
    """Blocks used BABA for ABAB, the sites' adapters rotated by one, or
    zeros in place of the embedding in each site's input: each moves the
    logits far beyond the tolerance."""
    cfg = _cfg()
    params = ref.make_params(MODEL, SEEDS[1], "cpu")
    tok = _tokens(SEEDS[1])
    base = zamba.forward(cfg, params, {"tokens": tok})
    if change == "block_order":
        params["blocks"] = params["blocks"][::-1]
    elif change == "adapter_index":
        sites = params["sites"]
        for key in ("lora_a", "lora_b"):
            vals = [sp[key] for sp in sites]
            for sp, v in zip(sites, vals[1:] + vals[:1]):
                sp[key] = v
    else:
        orig = zamba._block_input
        monkeypatch.setattr(zamba, "_block_input",
                            lambda cfg, bp, x, e: orig(cfg, bp, x,
                                                       torch.zeros_like(e)))
    got = zamba.forward(cfg, params, {"tokens": tok})
    assert float((got - base).abs().max()) > 50 * TOL


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_served_tree_matches_the_reference_at_its_bits(bits):
    """The engine's tree at ``bits`` (``quantize_tree`` then dequantized,
    as the hybrid family is served) against the reference at the same
    bits: the quantized leaves are the same ones on both sides."""
    from repro_torch.quant.ptq import dequantize_tree, quantize_tree
    cfg = _cfg()
    params = ref.make_params(MODEL, SEEDS[0], "cpu")
    tok = _tokens(SEEDS[0])
    served = dequantize_tree(quantize_tree(params, bits))
    got = _served(cfg, served, tok)
    torch.testing.assert_close(got, _reference(params, tok, bits), rtol=0,
                               atol=TOL)
    assert float((got - _reference(params, tok, 0)).abs().max()) > 50 * TOL


def test_gap_row_is_not_implemented():
    params = ref.make_params(MODEL, 1, "cpu")
    with pytest.raises(NotImplementedError):
        ref.forward_rows(params, MODEL, S_MAX,
                         [dict(prompt=[1, 2], gap=3, fed=[4], bits=0)])


def test_engine_serves_it():
    """``ServingEngine`` serves the small model: ``generate`` (the eager
    device-side loop on the CPU) equals ``generate_reference``, and every
    token equals the reference's greedy choice within its near-ties."""
    from repro_torch.serving.engine import ServingEngine
    cfg = _cfg()
    params = ref.make_params(MODEL, SEEDS[2], "cpu")
    eng = ServingEngine(cfg, params=params, batch_capacity=2, s_max=S_MAX,
                        n_max=N_FED, device="cpu")
    prompts = [t.tolist() for t in _tokens(SEEDS[2], n=S_MAX)]
    got = eng.generate(prompts, [N_FED, 3])
    again = eng.generate_reference(prompts, [N_FED, 3])
    assert (got.tokens == again.tokens).all()
    assert list(got.lengths) == [N_FED, 3]
    rows = [dict(prompt=p, gap=0, fed=got.tokens[i, :n - 1].tolist(),
                 bits=0) for i, (p, n) in enumerate(zip(prompts,
                                                        got.lengths))]
    for lg, row, n, toks in zip(ref.forward_rows(params, MODEL, S_MAX, rows),
                                rows, got.lengths, got.tokens):
        served = lg[torch.arange(n), torch.as_tensor(toks[:n]).long()]
        assert float((lg.max(-1).values - served).max()) <= TOL


# -- a site's decode attention on K4 -----------------------------------------

SITE_SCALE = (224 / 2) ** -0.5


def _site_slab(B, nh, nkv, dh, W, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((B, nh, dh), generator=g),
            torch.randn((B, W, nkv, dh), generator=g),
            torch.randn((B, W, nkv, dh), generator=g))


def test_flash_decode_at_a_site_equals_the_plain_attention():
    """``kops.flash_decode`` at a published site's shape (32 heads of 224
    over 32, W = 640, per-row n_valid 513-640) and scale, on the CPU,
    equals the masked softmax ``decode_attention_plain`` runs
    (``gqa_attention`` over the slots below n_valid) within 1e-6 at
    float32; the default scale gives other values."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import common
    W = 640
    q, k, v = _site_slab(4, 32, 32, 224, W, SEEDS[0])
    nv = torch.tensor([513, 577, 600, 640], dtype=torch.int32)
    got = kops.flash_decode(q, k, v, nv, scale=SITE_SCALE)
    want = common.gqa_attention(q[:, None], k, v, common._valid_mask(nv, W),
                                SITE_SCALE)[:, 0]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert float((kops.flash_decode(q, k, v, nv) - want).abs().max()) > 1e-3


def test_flash_decode_plain_default_scale_is_unchanged():
    """With no scale, the plain version at BLOOM-3B's 32 x 80 is bitwise
    its function before the argument: logits scaled by float32
    1/sqrt(d_head) computed in float32."""
    import numpy as np
    from repro_torch.kernels import flash_decode as fd
    q, k, v = _site_slab(4, 32, 32, 80, 640, SEEDS[1])
    nv = torch.tensor([1, 63, 64, 640], dtype=torch.int32)
    s = float(np.float32(1.0) / np.sqrt(np.float32(80)))
    logits = torch.einsum("bkgd,bskd->bkgs", q.reshape(4, 32, 1, 80), k) * s
    mask = torch.arange(640)[None, :] < nv[:, None]
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, -1e30))
    want = torch.einsum("bkgs,bskd->bkgd", torch.softmax(logits, dim=-1),
                        v).reshape(4, 32, 80)
    assert torch.equal(fd.flash_decode_plain(q, k, v, nv), want)
    assert torch.equal(fd.flash_decode_plain(q, k, v, nv, scale=s), want)


@torch.no_grad()
def test_published_decode_step_takes_flash_decode_once_a_site(monkeypatch):
    """A CPU decode step of the small published model calls
    ``kops.flash_decode`` once a site, at the block's scale, and never the
    masked softmax over float32 copies (``gqa_attention``); its logits
    still equal the reference's within ``TOL`` (the tests above)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import common
    cfg = _cfg()
    params = ref.make_params(MODEL, SEEDS[0], "cpu")
    tok = _tokens(SEEDS[0])
    _, cache = zamba.prefill(cfg, params, {"tokens": tok[:, :S_MAX]},
                             cache_len=S_MAX + N_FED)
    scales, plain = [], []
    real_fd, real_gqa = kops.flash_decode, common.gqa_attention
    monkeypatch.setattr(kops, "flash_decode", lambda q, k, v, nv,
                        scale=None: (scales.append(scale),
                                     real_fd(q, k, v, nv, scale))[1])
    monkeypatch.setattr(common, "gqa_attention", lambda *a, **kw: (
        plain.append(1), real_gqa(*a, **kw))[1])
    zamba.decode_step(cfg, params, cache, tok[:, S_MAX:S_MAX + 1], S_MAX)
    assert scales == [zamba._attn_scale(cfg)] * len(SITES)
    assert plain == []


# -- the equations against transformers --------------------------------------

def _hf_model(params):
    transformers = pytest.importorskip("transformers")
    from transformers.models.zamba2 import modeling_zamba2 as mz
    kinds = ["hybrid" if j in SITES else "mamba"
             for j in range(MODEL["n_layers"])]
    s = MODEL["ssm"]
    conf = transformers.Zamba2Config(
        vocab_size=MODEL["vocab"], hidden_size=MODEL["d_model"],
        num_hidden_layers=MODEL["n_layers"], layers_block_type=kinds,
        mamba_d_state=s["d_state"], mamba_d_conv=s["conv_width"],
        mamba_expand=s["expand"], mamba_ngroups=s["n_groups"],
        n_mamba_heads=s["expand"] * MODEL["d_model"] // s["head_dim"],
        # one chunk: transformers' torch path sums its inter-chunk states
        # over the wrong chunk index (against the recurrence its mixer
        # read 0.93 at chunk 1, 0.07 at 8 and 4.5e-6 at 16 over 16
        # tokens), so it is given the whole sequence as one chunk; the
        # program's multi-chunk scan is held to the reference above
        use_conv_bias=True, chunk_size=64,
        intermediate_size=MODEL["d_ff"], hidden_act="gelu",
        num_attention_heads=MODEL["n_heads"],
        num_key_value_heads=MODEL["n_kv_heads"], num_mem_blocks=2,
        use_shared_attention_adapter=False,
        adapter_rank=MODEL["hybrid"]["adapter_rank"], use_mem_rope=True,
        rope_theta=MODEL["rope_theta"], rms_norm_eps=1e-5,
        tie_word_embeddings=True, attn_implementation="eager",
        # the published kernel path with time_step_limit null does not
        # clamp dt; transformers' slow path clamps it at time_step_min,
        # set below any dt here
        time_step_min=1e-12, time_step_floor=1e-12)
    model = mz.Zamba2ForCausalLM(conf).to(torch.float32).eval()
    m = model.model
    T = lambda w: w.to(torch.float32).T.contiguous()  # noqa: E731
    with torch.no_grad():
        m.embed_tokens.weight.copy_(params["embed"])
        m.final_layernorm.weight.copy_(params["final_norm"])
        site = 0
        for j, layer in enumerate(m.layers):
            lp = params["mamba"][j]
            dec = layer.mamba_decoder if j in SITES else layer
            mx = dec.mamba
            dec.input_layernorm.weight.copy_(lp["norm"])
            mx.in_proj.weight.copy_(T(lp["in_proj"]))
            mx.conv1d.weight.copy_(T(lp["conv_w"])[:, None, :])
            mx.conv1d.bias.copy_(lp["conv_b"])
            for k in ("dt_bias", "A_log", "D"):
                getattr(mx, k).copy_(lp[k])
            mx.norm.weight.copy_(lp["gate_norm"])
            mx.out_proj.weight.copy_(T(lp["out_proj"]))
            if j not in SITES:
                continue
            bp, sp = params["blocks"][site % 2], params["sites"][site]
            blk = layer.shared_transformer
            at, ff = blk.self_attn, blk.feed_forward
            for name, w in (("q_proj", "wq"), ("k_proj", "wk"),
                            ("v_proj", "wv"), ("o_proj", "wo")):
                getattr(at, name).weight.copy_(T(bp["attn"][w]))
            ff.gate_up_proj.weight.copy_(T(torch.cat(
                [bp["ffn"]["w1"], bp["ffn"]["w3"]], 1)))
            ff.down_proj.weight.copy_(T(bp["ffn"]["w2"]))
            blk.input_layernorm.weight.copy_(bp["norm1"])
            blk.pre_ff_layernorm.weight.copy_(bp["norm2"])
            ad = ff.gate_up_proj_adapter_list[site]
            ad[0].weight.copy_(T(sp["lora_a"]))
            ad[1].weight.copy_(T(sp["lora_b"]))
            layer.linear.weight.copy_(T(sp["linear"]))
            site += 1
    return model


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_reference_equations_are_transformers(seed):
    """The reference's full-forward logits at every position against
    ``transformers``' ``Zamba2ForCausalLM`` (eager attention, its torch
    path) carrying the same weights: the block order, the adapters, the
    concatenation, the grouped scan and norm, the conv bias and the
    attention scale are the published ones."""
    params = ref.make_params(MODEL, seed, "cpu")
    model = _hf_model(params)
    tok = _tokens(seed, batch=1)
    with torch.no_grad():
        want = model(input_ids=tok, use_cache=False).logits[0]
    rows = [dict(prompt=tok[0, :1].tolist(), gap=0, fed=tok[0, 1:].tolist(),
                 bits=0)]
    got, = ref.forward_rows(params, MODEL, 1, rows, "cpu")
    torch.testing.assert_close(got, want, rtol=0, atol=HF_TOL)
