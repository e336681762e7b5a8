"""The fused int8 decode kernels K6/K7 (``csrc/flash_decode_fused.cu``)
checked on the CPU, where they cannot run.

``flash_decode.fused_plan`` cuts one call from the shapes alone: one
cluster of blocks per KV head, each block projecting q/k/v over its D rows
for every row of x, attending its own rows over 64-slot tiles, and taking
its wo columns.  ``_model`` below is that partition in numpy float32, with
its merge orders (a block's sums added over the cluster's blocks in rank
order, the heads' partials in head order, in x's type), and it is held
against the JAX package's Pallas kernel ``flash_decode_fused`` in interpret
mode at float32 tolerance, 1e-5 (both sum in float32, in other orders; the
a8 integer sums are exact).  That kernel stops at a name this JAX renamed
(ROADMAP Queue 3, F0): each test that runs it aliases the old name with
``monkeypatch`` for its own duration, and no file of the JAX package
changes.  The tensor-core steps are modelled lane by lane with the PTX
ISA's mma.m16n8k16 fragments: the int8 one (reusing the W8A8 GEMV's
model) must give the exact int32 sums of ``a8_accumulate_plain``, the bf16
one (int8 weights made bf16 in registers by an exact bit trick, a lane's
k rows 4t .. 4t + 3 taken as the k slots 2t, 2t + 1, 2t + 8, 2t + 9) the
exact products of x and w; a permuted fragment index must break either.  The kernel's own
bits are held by the card tests in ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.quant import ptq as jptq  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.quant_matmul import a8_accumulate_plain  # noqa: E402
from repro_torch.quant import ptq as tptq  # noqa: E402
from test_torch_qmm_a8_gemv_plan import (  # noqa: E402
    LANES, MMAS, SELECTORS, byte_perm, d_frag, d_frag_permuted, gv_transpose,
    mma, tile_element)

F32 = np.float32
TOL = dict(rtol=0, atol=1e-5)
THETA = 1e4

# (D, nkv, G, dh): BLOOM-7B1, BLOOM-3B, the GQA configs, ragged ones
SHAPES = [(4096, 32, 1, 128), (2560, 32, 1, 80), (4096, 8, 4, 128),
          (256, 2, 7, 128), (256, 2, 12, 32), (336, 3, 2, 80), (80, 1, 1, 32),
          (64, 40, 1, 16), (4096, 70, 1, 64), (48, 5, 3, 16)]


# -- the plan -----------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_d_rows_and_columns_once(shape):
    D, nkv, G, dh = shape
    plan = tfd.fused_plan(D, nkv, G, dh)
    C = plan.cluster
    assert 1 <= C <= tfd.FU_MAX_CLUSTER and C & (C - 1) == 0
    assert C == 1 or nkv * C <= 132
    for splits, per in ((plan.k_splits, plan.k_per_block),
                        (plan.wo_splits, plan.wo_per_block)):
        assert len(splits) == C and per % tfd.FU_KSTEP == 0
        assert splits[0][0] == 0 and splits[-1][1] == D
        assert all(a1 == b0 for (_, a1), (b0, _) in zip(splits, splits[1:]))
        assert all(stop - start <= per for start, stop in splits)
        assert all(start == min(D, r * per)
                   for r, (start, _) in enumerate(splits))
    rows = sorted(m for r in plan.rows for m in r)
    assert rows == list(range(tfd.FU_ROWS))
    assert all(m % C == r for r, own in enumerate(plan.rows) for m in own)
    assert plan.merge_order == tuple(range(C))
    assert plan.slot_tile == tfd.FU_BS


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_depends_on_the_shapes_only(shape):
    """No batch size, value, device or SM count enters the plan: the same
    plan on every call, before and after its cache is cleared."""
    plan = tfd.fused_plan(*shape)
    tfd.fused_plan.cache_clear()
    assert tfd.fused_plan(*shape) == plan
    assert list(tfd.fused_plan.__wrapped__.__code__.co_varnames[:4]) == [
        "D", "nkv", "G", "dh"]


def test_plan_fills_the_card_at_bloom_widths():
    """BLOOM-7B1 and BLOOM-3B (nkv = 32): 4 blocks a head, 128 blocks, one
    wave on the 132 SMs; each block's D rows and wo columns a quarter."""
    for D in (4096, 2560):
        plan = tfd.fused_plan(D, 32, 1, 128 if D == 4096 else 80)
        assert plan.cluster == 4
        assert plan.k_per_block == plan.wo_per_block == D // 4
        assert plan.rows == ((0, 4), (1, 5), (2, 6), (3, 7))


def test_constants_match_the_kernel_source():
    src = (Path(tfd.__file__).resolve().parent.parent / "csrc"
           / "flash_decode_fused.cu").read_text()
    found = dict(re.findall(r"constexpr int (FU_\w+) = (\d+);", src))
    for name in ("FU_ROWS", "FU_KSTEP", "FU_BN", "FU_BS", "FU_MAX_CLUSTER"):
        assert int(found[name]) == getattr(tfd, name), name
    assert int(found["FU_THREADS"]) // 32 == tfd.FU_WARPS
    assert "constexpr int FU_WARPS = FU_THREADS / 32;" in src


# -- the partition in numpy, against the JAX package's kernel ------------------


@pytest.fixture
def pallas(monkeypatch):
    """Let the JAX package's Pallas kernels run in interpret mode here."""
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)


def _quant_rows(v):
    """quantize_rowwise in numpy float32: (int8 rows, float32 scales)."""
    amax = np.abs(v).max(-1, keepdims=True).astype(F32)
    s = np.where(amax > 0, (amax * F32(tfd._INV_INT8_MAX)).astype(F32),
                 F32(1))
    return np.clip(np.round((v / s).astype(F32)), -128, 127).astype(
        np.int8), s


def _project(xr, w, s, a8, splits):
    """q/k/v or wo columns of rows xr over D rows cut by ``splits``: each
    block's float32 (a8: exact integer) sums, added in rank order, times
    the column scale after the sum (a8: acc * sx * s)."""
    if a8:
        xq, sx = _quant_rows(xr)
        acc = sum(xq[:, a:b].astype(np.int64) @ w[a:b].astype(np.int64)
                  for a, b in splits)
        return ((acc.astype(F32) * sx).astype(F32) * s).astype(F32)
    acc = None
    for a, b in splits:
        p = (xr[:, a:b] @ w[a:b].astype(F32)).astype(F32)
        acc = p if acc is None else (acc + p).astype(F32)
    return (acc * s).astype(F32)


def _rope(t, cos, sin):
    h = t.shape[-1] // 2
    t1, t2 = t[..., :h], t[..., h:]
    return np.concatenate([t1 * cos - t2 * sin, t1 * sin + t2 * cos],
                          -1).astype(F32)


def _attend(q, k1, v1, kc, vc, nv, ev, tile):
    """One row of one KV head: q (G, dh) scaled, k1/v1 (dh,), the cache
    (W, dh); online softmax over tiles of ``tile`` slots, then the current
    token."""
    G, dh = q.shape
    m = np.full(G, -1e30, F32)
    l = np.zeros(G, F32)
    acc = np.zeros((G, dh), F32)
    for s0 in range(0, nv, tile):
        n = min(tile, nv - s0)
        sc = (q @ kc[s0:s0 + n].T).astype(F32)
        ok = np.arange(s0, s0 + n) != ev
        sc = np.where(ok, sc, F32(-1e30))
        m_new = np.maximum(m, sc.max(-1))
        p = np.where(ok, np.exp(sc - m_new[:, None]), 0).astype(F32)
        alpha = np.exp(m - m_new).astype(F32)
        l = (alpha * l + p.sum(-1)).astype(F32)
        acc = (acc * alpha[:, None] + p @ vc[s0:s0 + n]).astype(F32)
        m = m_new
    s = (q @ k1).astype(F32)
    m_fin = np.maximum(m, s)
    p = np.exp(s - m_fin).astype(F32)
    alpha = np.exp(m - m_fin).astype(F32)
    l = (alpha * l + p).astype(F32)
    return ((acc * alpha[:, None] + p[:, None] * v1) / np.maximum(
        l, F32(1e-30))[:, None]).astype(F32)


def _model(x, ws, ck, cv, pos, a8):
    """K6 as the plan cuts it: x (B, D); ws name -> (int8 q, float32 s);
    the pre-write cache (B, W, nkv, dh).  Returns (o, k1, v1)."""
    B, D = x.shape
    W, nkv, dh = ck.shape[1:]
    G = ws["wq"][0].shape[1] // dh // nkv
    Gd = G * dh
    plan = tfd.fused_plan(D, nkv, G, dh)
    nv, ev = min(pos, W), (pos % W if pos >= W else -1)
    cos, sin = (t.numpy()[0] for t in ops._rope_rows(pos, dh, THETA, "cpu"))
    scale = F32(1.0 / dh ** 0.5)
    parts = np.zeros((B, nkv, D), F32)
    k1 = np.zeros((B, nkv, dh), F32)
    v1 = np.zeros((B, nkv, dh), F32)
    for h in range(nkv):
        cols = [(ws["wq"], slice(h * Gd, (h + 1) * Gd)),
                (ws["wk"], slice(h * dh, (h + 1) * dh)),
                (ws["wv"], slice(h * dh, (h + 1) * dh))]
        wcat = np.concatenate([q[:, c] for (q, _), c in cols], 1)
        scat = np.concatenate([s[c] for (_, s), c in cols])
        wo, so = ws["wo"][0][h * Gd:(h + 1) * Gd], ws["wo"][1]
        for g0 in range(0, B, tfd.FU_ROWS):             # one launch a group
            rows = x[g0:g0 + tfd.FU_ROWS]
            qkv = _project(rows, wcat, scat, a8, plan.k_splits)
            attn = np.zeros((len(rows), Gd), F32)
            for own in plan.rows:                        # a block's rows
                for m in own:
                    if m >= len(rows):
                        continue
                    b = g0 + m
                    r = qkv[m]
                    q = _rope(r[:Gd].reshape(G, dh), cos, sin) * scale
                    k1[b, h] = _rope(r[Gd:Gd + dh], cos, sin)
                    v1[b, h] = r[Gd + dh:]
                    attn[m] = _attend(q.astype(F32), k1[b, h], v1[b, h],
                                      ck[b, :, h], cv[b, :, h], nv, ev,
                                      plan.slot_tile).reshape(-1)
            for c0, c1 in plan.wo_splits:                # a block's columns
                parts[g0:g0 + len(rows), h, c0:c1] = _project(
                    attn, wo[:, c0:c1], so[c0:c1], a8, ((0, Gd),))
    o = parts[:, 0]
    for h in range(1, nkv):
        o = (o + parts[:, h]).astype(F32)
    return o, k1, v1


GEOMS = [(1, 128), (2, 80), (7, 32), (12, 32)]     # (G, dh)
POS = [0, 5, 16, 23]         # W = 16: empty, partial, full, the evicted slot


@pytest.mark.parametrize("act_bits", [16, 8])
@pytest.mark.parametrize("pos", POS)
@pytest.mark.parametrize("geom", GEOMS, ids=[f"G{g}-dh{d}" for g, d in GEOMS])
def test_model_matches_the_jax_kernel(pallas, geom, pos, act_bits):
    """The plan's partition and merge orders compute the reference's
    function: B = 9 rows (two launches), D = 64, two KV heads (a cluster
    of 8 blocks of 16 D rows, four of them with none)."""
    G, dh = geom
    nkv, D, B, W = 2, 64, 9, 16
    rng = np.random.default_rng(100 * G + dh + pos)
    shapes = {"wq": (D, G * nkv * dh), "wk": (D, nkv * dh),
              "wv": (D, nkv * dh), "wo": (G * nkv * dh, D)}
    wf = {n: (rng.normal(size=s) / np.sqrt(s[0])).astype(F32)
          for n, s in shapes.items()}
    jw = {n: jptq.quantize(jnp.asarray(w), 8, act_bits=act_bits)
          for n, w in wf.items()}
    tw = {n: tptq.quantize(torch.from_numpy(w), 8, act_bits=act_bits)
          for n, w in wf.items()}
    x = rng.normal(size=(B, D)).astype(F32)
    ck, cv = (rng.normal(size=(B, W, nkv, dh)).astype(F32) for _ in range(2))
    want = jops.flash_decode_fused(
        jnp.asarray(x), jw["wq"], jw["wk"], jw["wv"], jw["wo"],
        jnp.asarray(ck), jnp.asarray(cv), jnp.int32(pos), rope_theta=THETA)
    ws = {n: (t.q.numpy(), t.scale.reshape(-1).numpy()) for n, t in tw.items()}
    got = _model(x, ws, ck, cv, pos, act_bits == 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    if act_bits == 8:
        return   # the plain version may land an a8 attention value one int8
        # step apart from both (its float32 sums differ in the last bits)
    # and the port's plain version, which the card holds the kernel against
    plain = ops.flash_decode_fused(
        torch.from_numpy(x), tw["wq"], tw["wk"], tw["wv"], tw["wo"],
        torch.from_numpy(ck), torch.from_numpy(cv), pos, rope_theta=THETA)
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g, p.numpy(), **TOL)


# -- the tensor-core steps, lane by lane ----------------------------------------


def _qkv_columns(D, nkv, G, dh, rng):
    wq = rng.integers(-128, 128, size=(D, G * nkv * dh), dtype=np.int8)
    wk = rng.integers(-128, 128, size=(D, nkv * dh), dtype=np.int8)
    wv = rng.integers(-128, 128, size=(D, nkv * dh), dtype=np.int8)
    return wq, wk, wv


def _head_columns(wq, wk, wv, h, G, dh):
    Gd = G * dh
    return np.concatenate([wq[:, h * Gd:(h + 1) * Gd],
                           wk[:, h * dh:(h + 1) * dh],
                           wv[:, h * dh:(h + 1) * dh]], 1)


def _warp_units(plan, rank, D, NC):
    """(tile, warp, step) of every warp step block ``rank`` runs for q/k/v:
    the block's D rows in steps of 16, tiles of 128 columns, warp w taking
    steps w, w + 8, ... of every tile."""
    kb, ke = plan.k_splits[rank]
    nsteps = (ke - kb) // tfd.FU_KSTEP
    out = []
    for T in range(-(-NC // tfd.FU_BN)):
        for w in range(tfd.FU_WARPS):
            for j in range(w, nsteps, tfd.FU_WARPS):
                out.append((T, w, j, kb))
    return np.array(out, np.int64).reshape(-1, 4)


def _pieces(wcat, units):
    """Each lane's 16-byte pieces of a step, as 4 row words per column
    word: (S, 32, 4 rows, 4 words) uint32, and the (S, 32, 4) k rows."""
    D, NC = wcat.shape
    T, _, j, kb = units.T
    lanes = np.arange(LANES)
    g, t = lanes >> 2, lanes & 3
    k0 = kb[:, None] + tfd.FU_KSTEP * j[:, None] + 4 * t[None]
    rows = k0[..., None] + np.arange(4)
    cols = (T[:, None] * tfd.FU_BN + 16 * g[None])[..., None] + np.arange(16)
    wp = np.zeros((D + 1, NC + 1), np.int8)
    wp[:D, :NC] = wcat
    piece = wp[np.minimum(rows, D)[..., None],
               np.where(cols < NC, cols, NC)[..., None, :]]      # (S,32,4,16)
    words = piece.view(np.uint8).reshape(piece.shape[:3] + (4, 4)) \
        .copy().view(np.uint32)[..., 0]                           # (S,32,4,4)
    return words, rows


def _qkv_a8_model(xq, wcat, plan, d_map=d_frag):
    """The int8 q/k/v sums of one head as the kernel forms them: lane
    pieces, __byte_perm transposes, mma.sync s8 fragments, warp tiles
    added in warp order, each row's sums sent to its owner block and added
    there in rank order.  (M, NC) int64."""
    M, D = xq.shape
    NC = wcat.shape[1]
    C = plan.cluster
    xp = np.zeros((tfd.FU_ROWS + 1, D + 1), np.int8)
    xp[:M, :D] = xq
    recv = np.zeros((C, C, tfd.FU_ROWS, NC), np.int64)  # owner, src, row
    for rank in range(C):
        units = _warp_units(plan, rank, D, NC)
        if not len(units):
            continue
        words, rows = _pieces(wcat, units)
        g = np.arange(LANES) >> 2
        xr = np.where(g < M, g, tfd.FU_ROWS)[None, :, None]
        xb = xp[xr, np.minimum(rows, D)]                           # (S,32,4)
        xw = xb.view(np.uint8).copy().view(np.uint32)[..., 0]
        col = []
        for i in range(4):
            col += gv_transpose(*(words[:, :, r, i] for r in range(4)))
        d = np.stack([mma(col[2 * p], col[2 * p + 1], xw, d_map)
                      for p in range(MMAS)], 2)                    # (S,32,8,4)
        reg = d.transpose(0, 2, 3, 1).reshape(len(units), 32 * LANES)
        nT = -(-NC // tfd.FU_BN)
        tiles = np.zeros((nT, 32 * LANES), np.int64)
        np.add.at(tiles, units[:, 0], reg)
        for T in range(nT):
            for e in range(32 * LANES):
                m, c = tile_element(e)
                c += T * tfd.FU_BN
                if m < M and c < NC:
                    recv[m % C, rank, m, c] = tiles[T, e]
    out = np.zeros((M, NC), np.int64)
    for m in range(M):
        for src in plan.merge_order:
            out[m] += recv[m % C, src, m]
    return out


@pytest.mark.parametrize("shape", [(256, 2, 1, 128), (512, 32, 1, 128),
                                   (192, 2, 7, 32), (320, 3, 2, 80)])
@pytest.mark.parametrize("M", [1, 3, 8])
def test_a8_sums_equal_the_exact_sums(shape, M):
    """The kernel's int8 q/k/v sums of head 1 (K6's a8 path) equal
    ``a8_accumulate_plain`` bit for bit."""
    D, nkv, G, dh = shape
    rng = np.random.default_rng(D + M)
    wq, wk, wv = _qkv_columns(D, nkv, G, dh, rng)
    wcat = _head_columns(wq, wk, wv, 1, G, dh)
    x = rng.standard_normal((M, D)).astype(F32)
    xq, _ = tptq.quantize_rowwise(torch.from_numpy(x))
    plan = tfd.fused_plan(D, nkv, G, dh)
    want = a8_accumulate_plain(xq, torch.from_numpy(wcat)).numpy()
    np.testing.assert_array_equal(_qkv_a8_model(xq.numpy(), wcat, plan),
                                  want)


def test_a8_sums_notice_a_permuted_fragment():
    D, nkv, G, dh = 256, 2, 1, 128
    rng = np.random.default_rng(3)
    wcat = _head_columns(*_qkv_columns(D, nkv, G, dh, rng), 0, G, dh)
    xq, _ = tptq.quantize_rowwise(torch.from_numpy(
        rng.standard_normal((8, D)).astype(F32)))
    plan = tfd.fused_plan(D, nkv, G, dh)
    want = a8_accumulate_plain(xq, torch.from_numpy(wcat)).numpy()
    got = _qkv_a8_model(xq.numpy(), wcat, plan, d_map=d_frag_permuted)
    assert not np.array_equal(got, want)


# The PTX ISA's fragments of mma.m16n8k16 with .bf16 operands, lane (g, t):
# A register i (0..3) holds A[g + 8 (i % 2)][2 t + 8 (i // 2) + half];
# B register i (0, 1) holds B[2 t + 8 i + half][g]; D as the s8 one.
def a_frag_bf16(lane, i, half):
    g, t = lane >> 2, lane & 3
    return g + 8 * (i % 2), 2 * t + 8 * (i // 2) + half


def b_frag_bf16(lane, i, half):
    g, t = lane >> 2, lane & 3
    return 2 * t + 8 * i + half, g


def a_frag_bf16_wrong(lane, i, half):
    """The k slots of a lane taken as 4t .. 4t + 3 in A (not in B)."""
    g, t = lane >> 2, lane & 3
    return g + 8 * (i % 2), 4 * t + 2 * (i // 2) + half


def _halves(word):
    """bf16x2 words -> (low, high) as float32."""
    return ((word << np.uint32(16)).view(F32),
            (word & np.uint32(0xFFFF0000)).view(F32))


def i8pair_bf16x2(a, b, i):
    """``i8pair_bf16x2``: bytes i of a and b (int8) as one bf16x2 word, a's
    in the low half: bf16(128 + low 7 bits) - bf16(128 + 128 sign)."""
    p = byte_perm(a, b, i | i << 4 | (4 + i) << 8 | (4 + i) << 12)
    x = (p & np.uint32(0x007F007F)) | np.uint32(0x43004300)
    y = (p & np.uint32(0x00800080)) | np.uint32(0x43004300)
    (xl, xh), (yl, yh) = _halves(x), _halves(y)
    lo, hi = (xl - yl).astype(F32), (xh - yh).astype(F32)
    return (hi.view(np.uint32) & np.uint32(0xFFFF0000)) \
        | (lo.view(np.uint32) >> np.uint32(16))


def _bf16_step_model(words, xwords, a_map=a_frag_bf16, lo=None):
    """``step_bf16`` on one warp step: words (32, 4 rows, 4 words) of int8
    pieces, xwords (32, 2) bf16x2 words of x^T (lo: a second B summed on
    the same A).  Returns D (16 columns x 8 rows per mma, float64) placed
    back by the s8 D map: (8 mma, 32 lanes, 4 registers)."""
    out = np.zeros((MMAS, LANES, 4))
    for p in range(MMAS):
        wi, b0 = p >> 1, 2 * (p & 1)
        r = [words[:, k, wi] for k in range(4)]
        regs = [i8pair_bf16x2(r[0], r[1], b0), i8pair_bf16x2(r[0], r[1], b0 + 1),
                i8pair_bf16x2(r[2], r[3], b0), i8pair_bf16x2(r[2], r[3], b0 + 1)]
        A = np.zeros((16, 16))
        for lane in range(LANES):
            for i, reg in enumerate(regs):
                for half, v in enumerate(_halves(reg[lane:lane + 1])):
                    A[a_map(lane, i, half)] = v[0]
        D = np.zeros((16, 8))
        for xw in [xwords] + ([lo] if lo is not None else []):
            Bm = np.zeros((16, 8))
            for lane in range(LANES):
                for i in range(2):
                    for half, v in enumerate(_halves(xw[lane:lane + 1, i])):
                        Bm[b_frag_bf16(lane, i, half)] = v[0]
            D += A @ Bm
        for lane in range(LANES):
            for r in range(4):
                out[p, lane, r] = D[d_frag(lane, r)]
    return out


def test_int8_to_bf16_is_exact_for_every_byte():
    v = np.arange(-128, 128).astype(np.int8)
    a = np.repeat(v, 256).view(np.uint8).astype(np.uint32)
    b = np.tile(v, 256).view(np.uint8).astype(np.uint32)
    for i in range(4):
        lo, hi = _halves(i8pair_bf16x2(a << np.uint32(8 * i),
                                       b << np.uint32(8 * i), i))
        np.testing.assert_array_equal(lo, np.repeat(v, 256).astype(F32))
        np.testing.assert_array_equal(hi, np.tile(v, 256).astype(F32))


def _bf16_case(seed):
    """One warp step's pieces (16 k rows x 128 columns of int8) and x^T
    (8 rows x 16 k of bf16 values)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-128, 128, size=(16, 128), dtype=np.int8)
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(F32)) \
        .to(torch.bfloat16).float().numpy()
    lanes = np.arange(LANES)
    g, t = lanes >> 2, lanes & 3
    piece = w[(4 * t)[:, None, None] + np.arange(4)[None, :, None],
              (16 * g)[:, None, None] + np.arange(16)[None, None, :]]
    words = piece.view(np.uint8).reshape(LANES, 4, 4, 4).copy() \
        .view(np.uint32)[..., 0]                                 # (32,4,4)
    xk = x[g[:, None], 4 * t[:, None] + np.arange(4)]            # (32, 4)
    xb = (xk.view(np.uint32) >> np.uint32(16)).astype(np.uint32)
    xwords = (xb[:, 0::2] | (xb[:, 1::2] << np.uint32(16)))      # (32, 2)
    return w, x, words, xwords


def _bf16_want(w, x):
    """(8, 32, 4): the exact x @ w sums at each D register's (column, row)."""
    full = x.astype(np.float64) @ w.astype(np.float64)            # (8, 128)
    out = np.zeros((MMAS, LANES, 4))
    for p in range(MMAS):
        for lane in range(LANES):
            for r in range(4):
                m, c = tile_element((4 * p + r) * 32 + lane)
                out[p, lane, r] = full[m, c]
    return out


@pytest.mark.parametrize("seed", range(3))
def test_bf16_step_gives_the_exact_products(seed):
    """int8 -> bf16 is exact, a lane's k rows take the same k slots in A and
    B, and D lands where the writeout reads it: the step equals x @ w."""
    w, x, words, xwords = _bf16_case(seed)
    np.testing.assert_array_equal(_bf16_step_model(words, xwords),
                                  _bf16_want(w, x))


def test_bf16_step_notices_a_wrong_k_slot():
    w, x, words, xwords = _bf16_case(7)
    got = _bf16_step_model(words, xwords, a_map=a_frag_bf16_wrong)
    assert not np.array_equal(got, _bf16_want(w, x))


def test_bf16_hi_lo_parts_keep_sixteen_bits():
    """wo's B operand at a16: attn as bf16 hi + bf16 lo parts, within 2^-16
    of its float32 value (the step sums both on the same A)."""
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(F32))
    hi = a.to(torch.bfloat16)
    lo = (a - hi.float()).to(torch.bfloat16)
    err = (hi.float() + lo.float() - a).abs()
    assert bool((err <= a.abs() * 2.0 ** -16).all())
    w, x, words, xwords = _bf16_case(4)
    both = _bf16_step_model(words, xwords, lo=xwords)
    np.testing.assert_array_equal(both, 2 * _bf16_want(w, x))

