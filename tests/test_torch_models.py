"""The port's dense transformer against ``repro.models.transformer``:
prefill and decode-step logits at float32 on reduced configs, for float,
W8 and W4 trees.  The JAX side runs ``use_kernel=False`` on the
dequantized tree (its Pallas path does not run on this CPU); the port runs
its QTensor tree through the kernels' plain versions, with decode
attention through ``flash_decode`` (use_kernel) and without.  Also the
family facts every config's ``api.Model`` states for the serving engine."""
from __future__ import annotations

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conftest import REDUCTIONS, reduced_cfg  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.quant import ptq as jptq  # noqa: E402
from repro_torch import bridge, config  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch.serve import reduced  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.common import torch_dtype  # noqa: E402
from repro_torch.quant import ptq as tptq  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ARCHS = ["bloom-3b", "opt-13b", "olmo-1b"]   # layernorm+gelu, relu, nonparam_ln+silu
B, S, W = 2, 12, 20
TOL = 1e-4


def port_cfg(arch):
    return get_arch(arch).scaled(**REDUCTIONS[arch], dtype="float32")


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = reduced_cfg(arch).scaled(dtype="float32")
    p = jtr.init_params(cfg, jax.random.key(1))
    tp = bridge.from_jax_params(jax.device_get(p), device="cpu")
    toks = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(B, S)).astype(np.int32)
    return cfg, p, tp, toks


def _trees(arch, bits):
    cfg, p, tp, toks = _setup(arch)
    if bits == 0:
        return cfg, p, tp, toks
    return cfg, jptq.dequantize_tree(jptq.quantize_tree(p, bits)), \
        tptq.quantize_tree(tp, bits), toks


def test_port_config_matches_reference():
    for arch in ARCHS:
        a, b = reduced_cfg(arch).scaled(dtype="float32"), port_cfg(arch)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
                  "d_ff", "vocab", "norm", "act", "tie_embeddings",
                  "rope_theta"):
            assert getattr(a, f) == getattr(b, f), (arch, f)


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits(arch, bits):
    jcfg, jp, tp, toks = _trees(arch, bits)
    tcfg = port_cfg(arch)
    lj, cj = jtr.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, W)
    lt, ct = ttr.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, W)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ct[1]["k"].numpy(), np.asarray(cj["k"][1]),
                               rtol=TOL, atol=TOL)
    nxt = np.asarray(jnp.argmax(lj[:, :jcfg.vocab], -1))[:, None].astype(np.int32)
    dj, cj2 = jtr.decode_step(jcfg, jp, cj, jnp.asarray(nxt), jnp.int32(S))
    for use_kernel in (False, True):
        cache = [{k: v.clone() for k, v in c.items()} for c in ct]
        dt, cache = ttr.decode_step(tcfg, tp, cache, torch.from_numpy(nxt), S,
                                    use_kernel=use_kernel)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(cache[0]["v"].numpy(),
                                   np.asarray(cj2["v"][0]), rtol=TOL, atol=TOL)


def test_cache_wraps_like_reference():
    """Past the cache capacity, position p writes slot p % W."""
    jcfg, jp, tp, toks = _setup("bloom-3b")
    tcfg = port_cfg("bloom-3b")
    small = S - 4
    lj, cj = jtr.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, small)
    lt, ct = ttr.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, small)
    tok = np.full((B, 1), 5, np.int32)
    dj, _ = jtr.decode_step(jcfg, jp, cj, jnp.asarray(tok), jnp.int32(S))
    dt, _ = ttr.decode_step(tcfg, tp, ct, torch.from_numpy(tok), S,
                            use_kernel=True)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=TOL, atol=TOL)


def test_build_model_dense_only():
    m = api.build_model(port_cfg("bloom-3b"))
    gen = torch.Generator().manual_seed(0)
    params = m.init(gen)
    assert len(params["layers"]) == 2 and "lm_head" not in params
    assert params["embed"].shape == (512, 128)
    cache = m.init_cache(2, 16, "cpu")
    assert len(cache) == 2 and cache[0]["k"].shape == (2, 16, 4, 80)
    # every family builds: moe (and vlm), and the recurrent, hybrid and
    # audio families, with their own caches and no paged step
    for arch in ("xlstm-1.3b", "zamba2-7b", "whisper-tiny"):
        m = api.build_model(get_arch(arch).scaled(
            **REDUCTIONS[arch]))
        assert m.decode_step_paged is None
        assert all(leaf.shape[0] == 2 for layer in m.init_cache(2, 16, "cpu")
                   for leaf in layer.values())
    moe = api.build_model(get_arch("granite-moe-1b-a400m").scaled(
        **REDUCTIONS["granite-moe-1b-a400m"]))
    assert "moe" in moe.init(gen)["layers"][0]


def test_tied_unembed_reads_the_kept_dequantized_table():
    _, _, tp, _ = _setup("bloom-3b")
    q = tptq.quantize_tree(tp, 8)
    x = torch.randn(2, 1, 128, generator=torch.Generator().manual_seed(0))
    a = ttr._unembed(port_cfg("bloom-3b"), q, x)
    assert q["embed"]._dense is not None
    b = x @ tptq.dequantize(q["embed"]).T
    assert torch.equal(a, b)


# -- the family facts the serving engine asks of models.api.Model ---------

def _reduced(arch):
    """``arch`` at the suite's reduced size: ``reduced_cfg``'s cut from the
    port's registry; zamba2-7b-instruct at the published layout
    ``test_torch_zamba2_published`` cuts it to (three sites over nine
    layers)."""
    if arch == "zamba2-7b-instruct":
        from test_torch_zamba2_published import _cfg
        return _cfg()
    cfg, want = reduced(get_arch(arch)), reduced_cfg(arch)
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "d_head", "vocab", "sliding_window"):
        assert getattr(cfg, f) == getattr(want, f), (arch, f)
    for sub in ("moe", "encdec", "vlm"):
        a, b = getattr(cfg, sub), getattr(want, sub)
        assert (a is None) == (b is None), (arch, sub)
        if a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b), (arch, sub)
    return cfg


def _engine_facts(cfg, eng, bits):
    """The facts as the serving engine decided them from the family until
    the family modules stated them: (kernel_weights, decode tier at
    ``bits``, the stub embedding's name and length or None, whether the
    SSM and conv state is counted)."""
    transformer = cfg.family in ("dense", "moe", "vlm")
    if transformer:
        tier = kops.decode_kernel_tier(
            eng.params_for(bits)["layers"][0]["attn"], cfg)
    else:
        tier = "flash" if cfg.family == "hybrid" and cfg.hybrid.sites \
            else "none"
    stub = {"vlm": ("patch_embeds", cfg.vlm and cfg.vlm.n_img_tokens),
            "audio": ("audio_embeds",
                      cfg.encdec and cfg.encdec.n_audio_frames)
            }.get(cfg.family)
    return transformer, tier, stub, cfg.family == "hybrid"


@pytest.mark.parametrize("arch", config._ARCHS + config._PORT_ARCHS)
def test_family_facts_match_the_engine_table(arch):
    """Each config's ``Model`` states what the engine once decided from
    ``cfg.family``: kernel weights (QTensor leaves served, ``use_kernel``
    passed) exactly for the dense, MoE and VLM families; the engine's
    ``decode_tier`` at 0, 4, 8 and W8A8 ("flash" for the published
    Zamba2 layout); the prompt batch's stub embeddings; the SSM and conv
    state bytes on both Zamba2 layouts and None elsewhere."""
    cfg = _reduced(arch)
    model = api.build_model(cfg)
    eng = ServingEngine(cfg, batch_capacity=2, s_max=8, n_max=4,
                        device="cpu")
    for bits in (0, 4, 8, (8, 8)):
        kernel, tier, stub, counted = _engine_facts(cfg, eng, bits)
        assert model.kernel_weights is eng.model.kernel_weights is kernel
        assert eng.decode_tier(bits) == model.decode_tier(
            eng.params_for(bits)) == tier, bits
        quantized = any(isinstance(leaf, tptq.QTensor)
                        for leaf in tptq.tree_leaves(eng.params_for(bits)))
        assert quantized is (kernel and bits != 0), bits
    assert ("use_kernel" in eng._decode_kw) is kernel
    if arch == "zamba2-7b-instruct":
        assert tier == "flash"

    tokens = torch.ones((2, 8), dtype=torch.int32)
    batch = model.prompt_batch(tokens)
    assert batch["tokens"] is tokens
    assert sorted(batch) == sorted(["tokens"] + ([stub[0]] if stub else []))
    if stub:
        emb = batch[stub[0]]
        assert emb.shape == (2, stub[1], cfg.d_model)
        assert emb.dtype == torch_dtype(cfg) and not emb.any()

    cache = model.init_cache(2, 16, "cpu")
    want = 2 * sum(leaf.nbytes for layer in cache
                   for name, leaf in layer.items()
                   if name in ("ssm", "conv")) if counted else None
    assert model.state_bytes(cache) == want
    assert want is None or want > 0
