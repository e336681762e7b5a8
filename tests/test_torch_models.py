"""The port's dense transformer against ``repro.models.transformer``:
prefill and decode-step logits at float32 on reduced configs, for float,
W8 and W4 trees.  The JAX side runs ``use_kernel=False`` on the
dequantized tree (its Pallas path does not run on this CPU); the port runs
its QTensor tree through the kernels' plain versions, with decode
attention through ``flash_decode`` (use_kernel) and without."""
from __future__ import annotations

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
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.quant import ptq as tptq  # noqa: E402

ARCHS = ["bloom-3b", "opt-13b", "olmo-1b"]   # layernorm+gelu, relu, nonparam_ln+silu
B, S, W = 2, 12, 20
TOL = 1e-4


def port_cfg(arch):
    return get_arch(arch).scaled(**REDUCTIONS[arch], dtype="float32")


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = reduced_cfg(arch).scaled(dtype="float32")
    p = jtr.init_params(cfg, jax.random.key(1))
    tp = bridge.from_jax_params(jax.device_get(p), cfg.n_layers, "cpu")
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
    with pytest.raises(NotImplementedError):
        api.build_model(get_arch("bloom-3b").scaled(family="moe"))


def test_tied_unembed_reads_the_kept_dequantized_table():
    _, _, tp, _ = _setup("bloom-3b")
    q = tptq.quantize_tree(tp, 8)
    x = torch.randn(2, 1, 128, generator=torch.Generator().manual_seed(0))
    a = ttr._unembed(port_cfg("bloom-3b"), q, x)
    assert q["embed"]._dense is not None
    b = x @ tptq.dequantize(q["embed"]).T
    assert torch.equal(a, b)
