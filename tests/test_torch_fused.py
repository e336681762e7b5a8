"""The fused int8 decode tier (K6 over a slot cache, K7 through a block
table): the port's plain versions against the JAX package.

The JAX package's ``flash_decode_fused[_paged]`` are Pallas kernels, run
here in interpret mode.  On this jax they stop at a name the kernels use,
``pltpu.TPUCompilerParams``, renamed to ``pltpu.CompilerParams`` (ROADMAP
Queue 3, F0); each test that runs them aliases the old name with
``monkeypatch`` for its own duration, and no file of the JAX package
changes.  A second oracle needs no alias: the JAX package's unfused
composition (``qkv_proj``, ``cache_write``, ``ref.flash_decode_ref``,
``mm``).

Tolerances, at float32: 1e-5 against the Pallas kernels for o, k1 and v1
(both sum in float32, in another order; the a8 integer sums are exact);
1e-4 against the unfused composition, at a16 only (the fused kernel
quantizes a8's wo input per head group of G * dh values, the unfused path
per row of nh * dh values: a different function, as the JAX package's own
tests note).  Within the port, K7's plain version equals K6's bitwise on
the gathered pages.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.config import get_arch as jget_arch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.quant import ptq as jptq  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.quant import ptq as tptq  # noqa: E402

TOL = dict(rtol=0, atol=1e-5)
THETA = 1e4
W = 16


@pytest.fixture
def pallas(monkeypatch):
    """Let the JAX package's Pallas kernels run in interpret mode here."""
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)


def _weights(D, nh, nkv, dh, act_bits, seed):
    """The same int8 projections in both packages (quantized from the same
    float32 weights, bitwise equal) and a hidden row x (B=3, D)."""
    rng = np.random.default_rng(seed)
    shapes = {"wq": (D, nh * dh), "wk": (D, nkv * dh), "wv": (D, nkv * dh),
              "wo": (nh * dh, D)}
    ws = {n: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
          for n, s in shapes.items()}
    jw = {n: jptq.quantize(jnp.asarray(w), 8, act_bits=act_bits)
          for n, w in ws.items()}
    tw = {n: tptq.quantize(torch.from_numpy(w), 8, act_bits=act_bits)
          for n, w in ws.items()}
    x = rng.normal(size=(3, D)).astype(np.float32)
    return jw, tw, x


def _cache(B, nkv, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, W, nkv, dh)).astype(np.float32)
            for _ in range(2)]


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


GEOMS = [(1, 32), (2, 32), (1, 80), (2, 80), (1, 128), (2, 128)]  # (G, dh)
POS = [0, 5, W, W + 7]


@pytest.mark.parametrize("act_bits", [16, 8])
@pytest.mark.parametrize("pos", POS)
@pytest.mark.parametrize("geom", GEOMS, ids=[f"G{g}-dh{d}" for g, d in GEOMS])
def test_fused_plain_vs_pallas(pallas, geom, pos, act_bits):
    """K6's plain version against ``flash_decode_fused`` (interpret): pos 0
    (no valid slot), a partial fill, a full cache and the eviction slot."""
    G, dh = geom
    nkv, D = 2, 64
    jw, tw, x = _weights(D, G * nkv, nkv, dh, act_bits, seed=dh + G)
    ck, cv = _cache(3, nkv, dh, seed=pos)
    want = jops.flash_decode_fused(
        jnp.asarray(x), jw["wq"], jw["wk"], jw["wv"], jw["wo"],
        jnp.asarray(ck), jnp.asarray(cv), jnp.int32(pos), rope_theta=THETA)
    got = ops.flash_decode_fused(
        torch.from_numpy(x), tw["wq"], tw["wk"], tw["wv"], tw["wo"],
        torch.from_numpy(ck), torch.from_numpy(cv), pos, rope_theta=THETA)
    _close(got, want)


def _pages(ck, cv, bt, seed):
    """Scatter slabs (B, W, nkv, dh) into a shuffled page arena: returns
    (k_pages, v_pages, table)."""
    B = ck.shape[0]
    n_b = W // bt
    P = B * n_b + 3
    rng = np.random.default_rng(seed)
    table = rng.permutation(P)[:B * n_b].reshape(B, n_b).astype(np.int32)
    kp = rng.normal(size=(P, bt) + ck.shape[2:]).astype(np.float32)
    vp = rng.normal(size=(P, bt) + ck.shape[2:]).astype(np.float32)
    kp[table] = ck.reshape(B, n_b, bt, *ck.shape[2:])
    vp[table] = cv.reshape(B, n_b, bt, *cv.shape[2:])
    return kp, vp, table


@pytest.mark.parametrize("act_bits", [16, 8])
@pytest.mark.parametrize("pos", POS)
@pytest.mark.parametrize("geom", [(1, 80), (2, 128)],
                         ids=["G1-dh80", "G2-dh128"])
def test_fused_paged_plain_vs_pallas(pallas, geom, pos, act_bits):
    """K7's plain version against ``flash_decode_fused_paged`` (interpret)
    through a shuffled table of 8-slot pages, and bitwise equal to K6's
    plain version on the same values as a slab."""
    G, dh = geom
    nkv, D = 2, 64
    jw, tw, x = _weights(D, G * nkv, nkv, dh, act_bits, seed=7)
    ck, cv = _cache(3, nkv, dh, seed=pos + 1)
    kp, vp, table = _pages(ck, cv, 8, seed=pos)
    want = jops.flash_decode_fused_paged(
        jnp.asarray(x), jw["wq"], jw["wk"], jw["wv"], jw["wo"],
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table), jnp.int32(pos),
        rope_theta=THETA)
    tx = torch.from_numpy(x)
    got = ops.flash_decode_fused_paged(
        tx, tw["wq"], tw["wk"], tw["wv"], tw["wo"], torch.from_numpy(kp),
        torch.from_numpy(vp), torch.from_numpy(table), pos, rope_theta=THETA)
    _close(got, want)
    slab = ops.flash_decode_fused(tx, tw["wq"], tw["wk"], tw["wv"], tw["wo"],
                                  torch.from_numpy(ck), torch.from_numpy(cv),
                                  pos, rope_theta=THETA)
    for g, s in zip(got, slab):
        assert torch.equal(g, s)


@pytest.mark.parametrize("pos", POS)
@pytest.mark.parametrize("geom", [(1, 32), (2, 128)], ids=["G1-dh32",
                                                           "G2-dh128"])
def test_fused_plain_vs_unfused_composition(geom, pos):
    """Alias-free oracle at a16: the JAX package's project -> rope ->
    cache_write -> ``ref.flash_decode_ref`` -> wo on the post-write cache,
    with XLA matmuls on the dequantized weights, equals the fused function
    on the pre-write cache (1e-4)."""
    G, dh = geom
    nkv, D, B = 2, 64, 3
    jw, tw, x = _weights(D, G * nkv, nkv, dh, 16, seed=11)
    ck, cv = _cache(B, nkv, dh, seed=pos + 2)
    cfg = SimpleNamespace(d_head=dh, n_heads=G * nkv, n_kv_heads=nkv,
                          rope_theta=THETA, qk_norm=False)
    jd = {n: jptq.dequantize(w) for n, w in jw.items()}   # XLA matmuls
    jpos = jnp.int32(pos)
    positions = jnp.full((B, 1), jpos, jnp.int32)
    q, k1, v1 = jcommon.qkv_proj(jd, cfg, jnp.asarray(x)[:, None], positions,
                                 True)
    ck2, cv2 = jcommon.cache_write(jnp.asarray(ck), jnp.asarray(cv), k1, v1,
                                   jpos)
    att = jref.flash_decode_ref(q[:, 0], ck2, cv2, jnp.minimum(jpos + 1, W))
    out = jcommon.mm(att.reshape(B, G * nkv * dh), jd["wo"])
    got = ops.flash_decode_fused(
        torch.from_numpy(x), tw["wq"], tw["wk"], tw["wv"], tw["wo"],
        torch.from_numpy(ck), torch.from_numpy(cv), pos, rope_theta=THETA)
    _close(got, (out, k1[:, 0], v1[:, 0]), dict(rtol=0, atol=1e-4))


def _cfgs(nkv=2):
    """Reduced float32 BLOOM-7B1 (d_head 128) in both packages, with GQA."""
    dims = dict(n_layers=1, d_model=64, n_heads=2 * nkv, n_kv_heads=nkv,
                d_ff=128, vocab=256, dtype="float32")
    return jget_arch("bloom-7b1").scaled(**dims), \
        get_arch("bloom-7b1").scaled(**dims)


@pytest.mark.parametrize("act_bits", [16, 8])
@pytest.mark.parametrize("pos", [0, 5, W + 3])
def test_decode_attention_fused_branch_vs_jax(pallas, pos, act_bits):
    """The port's ``decode_attention`` (use_kernel) takes the fused branch
    for int8 projections and equals the JAX package's fused route: the
    output and the cache it writes."""
    jcfg, tcfg = _cfgs()
    jw, tw, x = _weights(64, 4, 2, 128, act_bits, seed=3)
    assert ops.fusable_decode(tw, tcfg) and jops.fusable_decode(jw, jcfg)
    ck, cv = _cache(3, 2, 128, seed=pos)
    jx = jnp.asarray(x)[:, None]
    o_j, ck_j, cv_j = jcommon.decode_attention(
        jw, jcfg, jx, jnp.asarray(ck), jnp.asarray(cv), jnp.int32(pos),
        use_kernel=True)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    ops.reset_launch_counts()
    o_t = common.decode_attention(tw, tcfg, torch.from_numpy(x)[:, None],
                                  tck, tcv, pos, use_kernel=True)
    assert not any(ops.launch_counts().values())     # plain versions
    _close((o_t, tck, tcv), (o_j, ck_j, cv_j))


@pytest.mark.parametrize("act_bits", [16, 8])
@pytest.mark.parametrize("pos", [0, 5, 11])
def test_decode_attention_paged_fused_branch_vs_jax(pallas, pos, act_bits):
    """The paged fused branch over the (nkv, dh) corner of a wider page
    tail, against the JAX package's: output and the pages written."""
    jcfg, tcfg = _cfgs()
    jw, tw, x = _weights(64, 4, 2, 128, act_bits, seed=4)
    bt, n_b, P = 8, 2, 9
    rng = np.random.default_rng(pos)
    table = rng.permutation(np.arange(2, P))[:3 * n_b].reshape(3, n_b) \
        .astype(np.int32)
    kp = rng.normal(size=(P, bt, 4, 160)).astype(np.float32)   # wider tail
    vp = rng.normal(size=(P, bt, 4, 160)).astype(np.float32)
    o_j, pages_j = jcommon.decode_attention_paged(
        jw, jcfg, jnp.asarray(x)[:, None], {"k": jnp.asarray(kp),
                                            "v": jnp.asarray(vp)},
        jnp.asarray(table), jnp.int32(pos), use_kernel=True)
    pages = {"k": torch.from_numpy(kp.copy()), "v": torch.from_numpy(vp.copy())}
    o_t = common.decode_attention_paged(
        tw, tcfg, torch.from_numpy(x)[:, None], pages,
        torch.from_numpy(table), pos, use_kernel=True)
    _close((o_t, pages["k"], pages["v"]), (o_j, pages_j["k"], pages_j["v"]))


def _gate_cases():
    """(name, act_bits / weight bits / fp, cfg overrides)."""
    return [("int8-a16-dh128", (8, 16), {}), ("int8-a8-dh128", (8, 8), {}),
            ("int4-dh128", (4, 16), {}), ("fp-dh128", None, {}),
            ("int8-qknorm", (8, 16), {"qk_norm": True}),
            ("int8-dh80", (8, 16), {"d_head": 80}),
            ("int8-a8-dh80", (8, 8), {"d_head": 80})]


@pytest.mark.parametrize("case", _gate_cases(), ids=lambda c: c[0])
def test_fused_gate_equals_reference_on_its_accelerator(monkeypatch, case):
    """``fusable_decode`` and ``decode_kernel_tier`` give the JAX package's
    answer off interpret mode (its tier choice on its accelerator)."""
    monkeypatch.setattr(jops, "INTERPRET", False)
    _, bits, over = case
    jcfg, tcfg = _cfgs()
    jcfg, tcfg = (dataclasses.replace(c, **over) for c in (jcfg, tcfg))
    dh = tcfg.d_head
    rng = np.random.default_rng(0)
    ws = {n: rng.normal(size=s).astype(np.float32) for n, s in (
        ("wq", (64, 4 * dh)), ("wk", (64, 2 * dh)), ("wv", (64, 2 * dh)),
        ("wo", (4 * dh, 64)))}
    if bits is None:
        jw = {n: jnp.asarray(w) for n, w in ws.items()}
        tw = {n: torch.from_numpy(w) for n, w in ws.items()}
    else:
        jw = {n: jptq.quantize(jnp.asarray(w), bits[0], act_bits=bits[1])
              for n, w in ws.items()}
        tw = {n: tptq.quantize(torch.from_numpy(w), bits[0],
                               act_bits=bits[1]) for n, w in ws.items()}
    assert ops.fusable_decode(tw, tcfg) == jops.fusable_decode(jw, jcfg)
    assert ops.decode_kernel_tier(tw, tcfg) == \
        jops.decode_kernel_tier(jw, jcfg)


def test_fused_gate_admits_bloom_7b1_and_not_bloom_3b():
    tw = {n: tptq.quantize(torch.ones(8, 8), 8) for n in
          ("wq", "wk", "wv", "wo")}
    assert ops.decode_kernel_tier(tw, get_arch("bloom-7b1")) == "fused"
    assert ops.decode_kernel_tier(tw, get_arch("bloom-3b")) == "flash"


def test_fused_cuda_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper takes CUDA tensors only: a CPU tensor is refused,
    never computed on the side; the plain version takes it."""
    _, tw, x = _weights(64, 2, 2, 32, 16, seed=0)
    ck, cv = (torch.from_numpy(a) for a in _cache(3, 2, 32, seed=0))
    cos, sin = ops._rope_rows(3, 32, THETA, "cpu")
    args = []
    for n in ("wq", "wk", "wv", "wo"):
        args += [tw[n].q, tw[n].scale.reshape(-1)]
    with pytest.raises(ValueError):
        tfd.flash_decode_fused_cuda(torch.from_numpy(x), *args, ck, cv, 3, -1,
                                    cos, sin)
    o, k1, v1 = tfd.flash_decode_fused_plain(torch.from_numpy(x), *args, ck,
                                             cv, 3, -1, cos, sin)
    assert o.shape == (3, 64) and k1.shape == v1.shape == (3, 2, 32)
