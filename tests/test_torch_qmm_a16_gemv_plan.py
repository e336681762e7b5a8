"""The W8A16 / W4A16 GEMV (``qmm_a16_gemv`` in ``csrc/quant_matmul.cu``, K1
and K3 at M <= 8 with bfloat16 x) checked on the CPU, where the kernel
cannot run.

``gemv_a16_plan`` cuts K into splits of whole warp steps (16 k rows, or 32
at bits 4) from N, K and bits alone; the splits of a 128-column tile form
one thread-block cluster.  ``_model`` below is the kernel in numpy, step by
step: which lane reads which 16-byte pieces (k rows 4t .. 4t + 3 at bits 8;
at bits 4 the packed rows 2t, 2t + 1, 2t + 8, 2t + 9 of a 16-row step),
zero past the split's end and past N; the weights made bf16 in registers
by the kernel's bit tricks (``i8pair_bf16x2``, ``nib_bf16x2``); the bf16
``mma.sync`` m16n8k16 with its operands placed by the PTX ISA's fragment
layout (A = W^T, B = x^T, a lane's k rows in the k slots 2t, 2t + 1,
2t + 8, 2t + 9 of both); float32 accumulation, one rounding per mma; the
warps' sums in warp order, the cluster's reduce-scatter with each owner
adding the splits in rank order; and the writeout's map from (register,
lane) to (row, column) and its ``s[n] * sum``.  Its float32 result is held
against ``repro.kernels.ref.quant_matmul_ref`` (the JAX reference's plain
oracle; the Pallas kernel stops at F0) at float32 tolerance, since both sum
exact products in float32 in other orders; rounded to bfloat16 it must sit
within the card's tolerance of the port's plain version.  A wrong selector
or a permuted k slot must break it.  The kernel's own bits are held by the
card tests in ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import inspect
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import quant_matmul as tqm  # noqa: E402
from repro_torch.quant import ptq as tptq  # noqa: E402
from test_torch_fused_plan import (  # noqa: E402
    a_frag_bf16, a_frag_bf16_wrong, b_frag_bf16)
from test_torch_qmm_a8_gemv_plan import (  # noqa: E402
    LANES, MMAS, byte_perm, d_frag, owner, tile_element)

F32 = np.float32
# float32 sums of exact products, in another order than the reference's
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-4)     # the card tests' bf16 tolerance

# BLOOM-3B's and BLOOM-7B1's decode shapes (K, N), and ragged ones: K not a
# multiple of a step or a split, odd K (bits 8 only), N not a multiple of 128
BLOOM = [(2560, 2560), (2560, 10240), (10240, 2560), (4096, 4096),
         (4096, 16384), (16384, 4096)]
RAGGED = [(80, 208), (64, 48), (256, 96), (83, 96), (34, 64), (1, 16),
          (1040, 400)]


def _kstep(bits):
    return tqm.GV_KSTEP4 if bits == 4 else tqm.GV_KSTEP


def _shapes(bits, kns):
    return [(bits, K, N) for K, N in kns if bits == 8 or K % 2 == 0]


# -- the plan -----------------------------------------------------------------


def _ranges(plan, K):
    return [(s * plan.k_per_split, min(K, (s + 1) * plan.k_per_split))
            for s in range(plan.grid[1])]


@pytest.mark.parametrize("bits,K,N", _shapes(8, BLOOM + RAGGED)
                         + _shapes(4, BLOOM + RAGGED))
def test_plan_covers_k_once(bits, K, N):
    plan = tqm.gemv_a16_plan(N, K, bits)
    r = _ranges(plan, K)
    assert r[0][0] == 0 and r[-1][1] == K
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(r, r[1:]))
    assert all(s1 > s0 for s0, s1 in r)            # no empty split
    assert plan.k_per_split % _kstep(bits) == 0
    assert 1 <= plan.grid[1] <= tqm.GV_MAX_SPLITS
    assert plan.grid[0] == math.ceil(N / tqm.GV_BN)
    assert plan.workspace_bytes == 0


def test_plan_depends_on_n_k_and_bits_only():
    """No M, no values, no device and no SM count enter the plan, so each
    row of an M = 8 call is summed in the order it is summed alone; at
    bits 8 it is the W8A8 GEMV's partition."""
    assert list(inspect.signature(tqm.gemv_a16_plan).parameters) == [
        "N", "K", "bits"]
    for bits, K, N in _shapes(8, BLOOM + RAGGED) + _shapes(4, BLOOM):
        plan = tqm.gemv_a16_plan(N, K, bits)
        tqm.gemv_a16_plan.cache_clear()
        assert tqm.gemv_a16_plan(N, K, bits) == plan
        if bits == 8:
            assert plan == tqm.gemv_a8_plan(8, N, K)
    with pytest.raises(ValueError):
        tqm.gemv_a16_plan(256, 256, 16)


@pytest.mark.parametrize("bits", [8, 4])
def test_plan_fills_the_card_at_bloom_widths(bits):
    """At BLOOM's decode widths the grid covers the H100's 132 SMs at least
    once, and every warp of a block has a step of each split."""
    for K, N in BLOOM:
        plan = tqm.gemv_a16_plan(N, K, bits)
        assert plan.grid[0] * plan.grid[1] >= 132, (K, N, plan)
        assert plan.k_per_split >= tqm.GV_WARPS * _kstep(bits)


def _source():
    return (Path(tqm.__file__).resolve().parent.parent / "csrc"
            / "quant_matmul.cu").read_text()


def test_constants_match_the_kernel_source():
    src = _source()
    found = dict(re.findall(r"constexpr int (GV_\w+) = (\d+);", src))
    for name in ("GV_WARPS", "GV_BN", "GV_KSTEP", "GV_KSTEP4",
                 "GV_MAX_SPLITS"):
        assert int(found[name]) == getattr(tqm, name), name
    assert int(found["GV_ROWS"]) == 8 == tqm._SKINNY_ROWS
    # the bit tricks the model below reproduces
    for text in ("(i | i << 4 | (4 + i) << 8 | (4 + i) << 12)",
                 "(p & 0x007F007Fu) | 0x43004300u",
                 "(p & 0x00800080u) | 0x43004300u",
                 "(i | (4 + i) << 8)",
                 "((p & 0x000F000Fu) | 0x43004300u) ^ 0x00080008u, 0x43084308u",
                 "k0 + 2 * (i & 1) + 16 * (i >> 1)"):
        assert text in src, text


def test_wide_loads_where_the_operands_take_them():
    x = torch.zeros((8, 2560), dtype=torch.bfloat16)
    q = torch.zeros((2560, 2560), dtype=torch.int8)
    assert tqm.gemv_a16_wide(x, q, 8)
    assert tqm.gemv_a16_wide(x, q[:1280], 4)
    assert tqm.gemv_a16_wide(x[:, :83], q[:83, :96].contiguous(), 8)
    assert not tqm.gemv_a16_wide(x[:, :83], q[:42, :96].contiguous(), 4)
    assert not tqm.gemv_a16_wide(x[:, :64], torch.zeros((64, 200),
                                                        dtype=torch.int8), 8)
    odd = torch.zeros(64 * 96 + 1, dtype=torch.int8)[1:].view(64, 96)
    assert not tqm.gemv_a16_wide(x[:, :64], odd, 8)
    off = torch.zeros(8 * 64 + 1, dtype=torch.bfloat16)[1:].view(8, 64)
    assert not tqm.gemv_a16_wide(off, torch.zeros((64, 96),
                                                  dtype=torch.int8), 8)


# -- the bit tricks -----------------------------------------------------------


def _halves(word):
    """bf16x2 words -> (low, high) as float32."""
    return ((word << np.uint32(16)).view(F32),
            (word & np.uint32(0xFFFF0000)).view(F32))


def bf16x2_sub(x, y):
    """``bf16x2_sub``: x - y half by half, rounded to bf16 (the values here
    are small integers, exact)."""
    (xl, xh), (yl, yh) = _halves(x), _halves(np.broadcast_to(
        np.asarray(y, np.uint32), np.shape(x)))
    lo = torch.from_numpy((xl - yl).astype(F32)).to(torch.bfloat16)
    hi = torch.from_numpy((xh - yh).astype(F32)).to(torch.bfloat16)
    lo = lo.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
    hi = hi.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
    return (hi << np.uint32(16)) | lo


I8_SEL = lambda i: i | i << 4 | (4 + i) << 8 | (4 + i) << 12  # noqa: E731
NIB_SEL = lambda i: i | (4 + i) << 8  # noqa: E731


def i8pair_bf16x2(a, b, i, sel=I8_SEL):
    """``i8pair_bf16x2``: bytes i of a and b (int8) as one bf16x2 word, a's
    in the low half: bf16(128 + low 7 bits) - bf16(128 + 128 sign)."""
    p = byte_perm(a, b, sel(i))
    return bf16x2_sub((p & np.uint32(0x007F007F)) | np.uint32(0x43004300),
                      (p & np.uint32(0x00800080)) | np.uint32(0x43004300))


def nib_bf16x2(w, w4, i, sel=NIB_SEL):
    """``nib_bf16x2``: byte i of a packed word w (w4 = w >> 4) as the bf16x2
    of its two signed nibbles, the low nibble in the low half:
    bf16(128 + (n ^ 8)) - bf16(136)."""
    p = byte_perm(w, w4, sel(i))
    return bf16x2_sub(((p & np.uint32(0x000F000F)) | np.uint32(0x43004300))
                      ^ np.uint32(0x00080008), 0x43084308)


def test_int8_to_bf16_is_exact_for_every_byte():
    v = np.arange(-128, 128).astype(np.int8)
    a = np.repeat(v, 256).view(np.uint8).astype(np.uint32)
    b = np.tile(v, 256).view(np.uint8).astype(np.uint32)
    for i in range(4):
        lo, hi = _halves(i8pair_bf16x2(a << np.uint32(8 * i),
                                       b << np.uint32(8 * i), i))
        np.testing.assert_array_equal(lo, np.repeat(v, 256).astype(F32))
        np.testing.assert_array_equal(hi, np.tile(v, 256).astype(F32))


def test_int4_to_bf16_is_exact_for_every_nibble():
    """Every byte of a packed word, in each of its 4 positions, gives its
    low nibble (the even k row) and its high nibble (the odd one) as the
    signed values ``ptq.unpack_int4`` gives."""
    b = np.arange(256, dtype=np.uint32)
    want = tptq.unpack_int4(torch.from_numpy(
        b.astype(np.uint8).view(np.int8)[None])).numpy().astype(F32)
    for i in range(4):
        w = (b << np.uint32(8 * i)) | np.uint32(0x5A5A5A5A & ~(0xFF << 8 * i))
        lo, hi = _halves(nib_bf16x2(w, w >> np.uint32(4), i))
        np.testing.assert_array_equal(lo, want[0])
        np.testing.assert_array_equal(hi, want[1])
    assert want.min() == -8 and want.max() == 7


# -- a model of the kernel ----------------------------------------------------


def _frag_index(fn, regs):
    """Index arrays (row, col) of fragment ``fn(lane, reg, half)`` over
    lanes x regs x halves, in that order."""
    cells = [fn(lane, i, h) for lane in range(LANES) for i in range(regs)
             for h in range(2)]
    return tuple(np.array(c) for c in zip(*cells))


def _warp_steps(plan, K, kstep):
    """(tile, split, warp, step, split start, split end) of every warp step
    the grid runs, each warp's in the order the warp sums them: steps
    j0, j0 + GV_WARPS for j0 = warp, warp + 2 GV_WARPS, ... while
    j0 < steps (the second of a pair may lie past the split: zero)."""
    out = []
    for bx in range(plan.grid[0]):
        for s, (kb, ke) in enumerate(_ranges(plan, K)):
            steps = -(-(ke - kb) // kstep)
            for w in range(tqm.GV_WARPS):
                for j0 in range(w, steps, 2 * tqm.GV_WARPS):
                    for j in (j0, j0 + tqm.GV_WARPS):
                        out.append((bx, s, w, j, kb, ke))
    return np.array(out, np.int64).reshape(-1, 6)


def _bf16_bits(v):
    return (torch.from_numpy(np.ascontiguousarray(v, F32)).to(torch.bfloat16)
            .view(torch.int16).numpy().view(np.uint16).astype(np.uint32))


def _model(x, q, s, bits, i8_sel=I8_SEL, nib_sel=NIB_SEL, a_map=a_frag_bf16):
    """The kernel's float32 output s[n] * sum before its bf16 rounding,
    (M, N), from x (M, K) float32 holding bf16 values, q int8 (K, N) or
    packed (ceil(K / 2), N), s (N,) float32."""
    M, K = x.shape
    N = q.shape[1]
    kstep = _kstep(bits)
    chunks = 2 if bits == 4 else 1
    plan = tqm.gemv_a16_plan(N, K, bits)
    ws = _warp_steps(plan, K, kstep)
    bx, split, warp, j, kb, ke = ws.T
    lanes = np.arange(LANES)
    g, t = lanes >> 2, lanes & 3
    # the lane's first k row, its 4 pieces' k rows and 16 columns
    k0 = kb[:, None] + kstep * j[:, None] + 4 * t[None]             # (S, 32)
    koff = np.array([0, 2, 16, 18]) if bits == 4 else np.arange(4)
    krow = k0[..., None] + koff                                      # (S,32,4)
    n = bx[:, None] * tqm.GV_BN + 16 * g[None]
    cols = n[..., None] + np.arange(16)                              # (S,32,16)
    rin = krow < ke[:, None, None]
    prow = krow >> 1 if bits == 4 else krow
    qp = np.zeros((q.shape[0] + 1, N + 1), np.int8)
    qp[:-1, :N] = q
    piece = qp[np.where(rin, prow, q.shape[0])[..., None],
               np.where(cols < N, cols, N)[..., None, :]]            # (S,32,4,16)
    words = piece.view(np.uint8).reshape(piece.shape[:3] + (4, 4)) \
        .copy().view(np.uint32)[..., 0]                               # (S,32,4,4)
    # x^T words: x[g][k0 + 16 c .. + 3] as bf16 pairs, zero past ke / M
    xbits = np.zeros((9, K + 1), np.uint32)
    xbits[:M, :K] = _bf16_bits(x)
    xk = k0[:, :, None, None] + 16 * np.arange(chunks)[:, None] \
        + np.arange(4)                                                # (S,32,C,4)
    xin = (xk < ke[:, None, None, None]) & (g[None, :, None, None] < M)
    xv = xbits[np.where(xin, g[None, :, None, None], 8),
               np.where(xin, xk, K)]
    xw = xv[..., 0::2] | (xv[..., 1::2] << np.uint32(16))            # (S,32,C,2)
    A_idx, B_idx = _frag_index(a_map, 4), _frag_index(b_frag_bf16, 2)
    D_idx = tuple(np.array(c) for c in zip(*[d_frag(lane, r)
                                             for lane in range(LANES)
                                             for r in range(4)]))
    S = len(ws)
    d = np.zeros((S, chunks, MMAS, LANES, 4))
    for c in range(chunks):
        Bm = np.zeros((S, 16, 8))
        Bm[:, B_idx[0], B_idx[1]] = np.stack(
            _halves(xw[:, :, c]), -1).reshape(S, -1)
        for p in range(MMAS):
            wi, b0 = p >> 1, 2 * (p & 1)
            if bits == 4:
                r0, r1 = words[:, :, 2 * c, wi], words[:, :, 2 * c + 1, wi]
                s0, s1 = r0 >> np.uint32(4), r1 >> np.uint32(4)
                regs = [nib_bf16x2(r0, s0, b0, nib_sel),
                        nib_bf16x2(r0, s0, b0 + 1, nib_sel),
                        nib_bf16x2(r1, s1, b0, nib_sel),
                        nib_bf16x2(r1, s1, b0 + 1, nib_sel)]
            else:
                r = [words[:, :, k, wi] for k in range(4)]
                regs = [i8pair_bf16x2(r[0], r[1], b0, i8_sel),
                        i8pair_bf16x2(r[0], r[1], b0 + 1, i8_sel),
                        i8pair_bf16x2(r[2], r[3], b0, i8_sel),
                        i8pair_bf16x2(r[2], r[3], b0 + 1, i8_sel)]
            A = np.zeros((S, 16, 16))
            A[:, A_idx[0], A_idx[1]] = np.stack(
                [np.stack(_halves(reg), -1) for reg in regs], 2).reshape(S, -1)
            D = A @ Bm                                    # exact products
            d[:, c, p] = D[:, D_idx[0], D_idx[1]].reshape(S, LANES, 4)
    # each warp's accumulators, its steps (and chunks) in order, one float32
    # rounding per mma
    group = (bx * plan.grid[1] + split) * tqm.GV_WARPS + warp
    order = np.zeros(S, np.int64)
    for i in range(1, S):
        order[i] = order[i - 1] + 1 if group[i] == group[i - 1] else 0
    acc = np.zeros((plan.grid[0] * plan.grid[1] * tqm.GV_WARPS, MMAS,
                    LANES, 4), F32)
    for o in range(order.max() + 1):
        sel = order == o
        for c in range(chunks):
            acc[group[sel]] = (acc[group[sel]]
                               + d[sel, c]).astype(F32)
    # a block's tile, element e = 32 register + lane, register = 4 p + r;
    # its warps added in warp order
    reg = acc.transpose(0, 1, 3, 2).reshape(plan.grid[0], plan.grid[1],
                                            tqm.GV_WARPS, 32 * LANES)
    blocks = np.zeros(reg.shape[:2] + reg.shape[3:], F32)
    for v in range(tqm.GV_WARPS):
        blocks = (blocks + reg[:, :, v]).astype(F32)
    # the reduce-scatter: block `rank` sends element e to slot
    # rank * chunk + e % chunk of block e // chunk, which adds its slots in
    # rank order
    splits = plan.grid[1]
    e = np.arange(32 * LANES)
    dest, off, chunk = owner(e, splits)
    recv = np.zeros((plan.grid[0], splits, splits * chunk), F32)
    for rank in range(splits):
        recv[:, dest, rank * chunk + off] = blocks[:, rank, e]
    tile = np.zeros((plan.grid[0], 32 * LANES), F32)
    for rank in range(splits):
        tile = (tile + recv[:, dest, rank * chunk + off]).astype(F32)
    out = np.zeros((M, plan.grid[0] * tqm.GV_BN), F32)
    for i in range(32 * LANES):
        m, c = tile_element(i)
        if m < M:
            out[m, c::tqm.GV_BN] = tile[:, i]
    return (s[None, :] * out[:, :N]).astype(F32)


def _inputs(M, K, N, bits, seed):
    """x rounded to bf16 (held as float32), weights from normal / sqrt(K)
    quantized by the port's PTQ (int8, or packed int4), their scales."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(F32)) \
        .to(torch.bfloat16).float().numpy()
    w = torch.from_numpy((rng.standard_normal((K, N)) / np.sqrt(K))
                         .astype(F32))
    t = tptq.quantize(w, bits)
    return x, t.q.numpy(), t.scale.reshape(-1).numpy()


MODEL_KN = [(2560, 2560), (1040, 400)] + RAGGED


@pytest.mark.parametrize("bits,K,N", _shapes(8, MODEL_KN)
                         + _shapes(4, MODEL_KN))
@pytest.mark.parametrize("M", [1, 3, 8])
def test_model_equals_the_jax_reference(M, bits, K, N):
    """The model's float32 result equals the reference's oracle
    ``quant_matmul_ref`` (x (q s), float32 sums) within float32 summation
    error; rounded to bf16 it is within the card tests' bf16 tolerance of
    the port's plain version on bf16 x."""
    x, q, s = _inputs(M, K, N, bits, K * N + M + bits)
    got = _model(x, q, s, bits)
    if bits == 8 or K % 2 == 0:
        want = np.asarray(ref.quant_matmul_ref(
            jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), bits))
        np.testing.assert_allclose(got, want, **F32_TOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    torch.testing.assert_close(
        torch.from_numpy(got).to(torch.bfloat16),
        tqm.quant_matmul_plain(xb, torch.from_numpy(q), torch.from_numpy(s),
                               bits), **BF16_TOL)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kn", [(2560, 2560), (1040, 400), (80, 208)])
def test_rows_of_eight_equal_rows_alone(bits, kn):
    """Row r of the M = 8 model equals the same row computed at M = 1,
    bit for bit: the plan and every sum's order are M's alone."""
    K, N = kn
    x, q, s = _inputs(8, K, N, bits, 3 * K + N)
    full = _model(x, q, s, bits)
    for r in range(8):
        np.testing.assert_array_equal(_model(x[r:r + 1], q, s, bits)[0],
                                      full[r])


@pytest.mark.parametrize("bits,fault", [(8, "selector"), (8, "kslot"),
                                        (4, "selector"), (4, "kslot")])
def test_model_notices_a_wrong_layout(bits, fault):
    """The model can fail: a wrong byte-permute selector (bits 8: the
    second row's byte taken from the first row; bits 4: the two nibbles
    swapped) or a lane's k rows taken as k slots 4t .. 4t + 3 in A but not
    in B break the result."""
    x, q, s = _inputs(8, 256, 96, bits, 7)
    want = np.asarray(ref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(q),
                                           jnp.asarray(s), bits))
    kw = {}
    if fault == "kslot":
        kw["a_map"] = a_frag_bf16_wrong
    elif bits == 8:
        kw["i8_sel"] = lambda i: i | i << 4 | i << 8 | i << 12
    else:
        kw["nib_sel"] = lambda i: (4 + i) | i << 8
    got = _model(x, q, s, bits, **kw)
    assert not np.allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(_model(x, q, s, bits), want, **F32_TOL)
