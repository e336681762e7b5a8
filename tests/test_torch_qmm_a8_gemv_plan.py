"""The W8A8 GEMV (``qmm_a8_gemv`` in ``csrc/quant_matmul.cu``, K2 at M <= 8)
checked on the CPU, where the kernel cannot run.

``gemv_a8_plan`` cuts K into splits of whole warp steps; the splits of a
128-column tile form one thread-block cluster.  ``_model`` below is the
kernel in numpy, step by step: which lane reads which 4 k rows of which 16
columns (16-byte pieces, zero past the split's end and past N), the 4x4 byte
transposes of ``gv_transpose``, the int8 ``mma.sync`` m16n8k16 with its
operands placed by the PTX ISA's fragment layout (A = W^T, B = xq^T, D
int32), the warps' sums per block, the cluster's reduce-scatter (each block
receives every split's sums for its share of the tile) and the writeout's
map from (register, lane) to (row, column).  Integer sums are
exact, so the model must equal ``a8_accumulate_plain`` exactly and, after
the writeout ``float(acc) * sx * sw``, ``repro.kernels.ref``'s W8A8 result
bit for bit; a wrong byte-permute selector or a permuted fragment index
must break it.  The kernel's own bits are held by the card tests in
``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

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

LANES = 32
MMAS = 8          # mma of a warp step: 16 columns a lane, 2 a mma

# BLOOM-3B's and BLOOM-7B1's decode shapes (K, N), and the ragged ones the
# byte-load instantiation takes
BLOOM = [(2560, 2560), (2560, 10240), (10240, 2560), (4096, 4096),
         (4096, 16384), (16384, 4096)]
RAGGED = [(80, 200), (64, 33), (256, 96), (83, 96), (33, 64), (1, 16)]


# -- the plan -----------------------------------------------------------------


def _ranges(plan, K):
    return [(s * plan.k_per_split, min(K, (s + 1) * plan.k_per_split))
            for s in range(plan.grid[1])]


@pytest.mark.parametrize("kn", BLOOM + RAGGED)
@pytest.mark.parametrize("M", [1, 2, 3, 7, 8])
def test_plan_covers_k_once(M, kn):
    K, N = kn
    plan = tqm.gemv_a8_plan(M, N, K)
    r = _ranges(plan, K)
    assert r[0][0] == 0 and r[-1][1] == K
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(r, r[1:]))
    assert all(s1 > s0 for s0, s1 in r)            # no empty split
    assert plan.k_per_split % tqm.GV_KSTEP == 0
    assert 1 <= plan.grid[1] <= tqm.GV_MAX_SPLITS
    assert plan.grid[0] == math.ceil(N / tqm.GV_BN)


@pytest.mark.parametrize("kn", BLOOM + RAGGED)
def test_plan_depends_on_the_shapes_only(kn):
    """The same plan for every M <= 8 and every call: no values, no device
    and no SM count enter it; and no workspace, since a tile's splits
    merge inside their cluster."""
    K, N = kn
    plans = {tqm.gemv_a8_plan(M, N, K) for M in range(1, 9)}
    assert len(plans) == 1
    plan = plans.pop()
    assert plan.workspace_bytes == 0
    tqm.gemv_a8_plan.cache_clear()
    assert tqm.gemv_a8_plan(8, N, K) == plan


def test_plan_fills_the_card_at_bloom_widths():
    """At BLOOM's decode widths the grid covers the H100's 132 SMs at least
    once, and every warp of a block has a step of each split."""
    for K, N in BLOOM:
        plan = tqm.gemv_a8_plan(8, N, K)
        assert plan.grid[0] * plan.grid[1] >= 132, (K, N, plan)
        assert plan.k_per_split >= tqm.GV_WARPS * tqm.GV_KSTEP


def test_plan_refuses_more_than_eight_rows():
    with pytest.raises(ValueError):
        tqm.gemv_a8_plan(9, 256, 256)


def test_constants_match_the_kernel_source():
    src = (Path(tqm.__file__).resolve().parent.parent / "csrc"
           / "quant_matmul.cu").read_text()
    found = dict(re.findall(r"constexpr int (GV_\w+) = (\d+);", src))
    for name in ("GV_WARPS", "GV_BN", "GV_KSTEP", "GV_MAX_SPLITS"):
        assert int(found[name]) == getattr(tqm, name), name
    assert int(found["GV_ROWS"]) == 8 == tqm._SKINNY_ROWS


def test_wide_loads_where_the_operands_take_them():
    xq = torch.zeros((8, 2560), dtype=torch.int8)
    q = torch.zeros((2560, 2560), dtype=torch.int8)
    assert tqm.gemv_wide(xq, q)
    assert not tqm.gemv_wide(xq[:, :83], torch.zeros((83, 96),
                                                     dtype=torch.int8))
    assert not tqm.gemv_wide(xq[:, :64], torch.zeros((64, 200),
                                                     dtype=torch.int8))
    odd = torch.zeros(64 * 96 + 1, dtype=torch.int8)[1:].view(64, 96)
    assert not tqm.gemv_wide(xq[:, :64], odd)
    off = torch.zeros(8 * 64 + 2, dtype=torch.int8)[2:].view(8, 64)
    assert not tqm.gemv_wide(off, torch.zeros((64, 96), dtype=torch.int8))


# -- a model of the kernel ----------------------------------------------------


def byte_perm(x, y, s):
    """CUDA's ``__byte_perm`` on uint32 arrays: byte i of the result is
    byte (s >> 4 i) & 7 of the eight bytes of (y:x)."""
    src = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(np.shape(src), np.uint64)
    for i in range(4):
        sel = np.uint64(8 * ((s >> (4 * i)) & 7))
        out |= ((src >> sel) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


SELECTORS = dict(lo=0x5140, hi=0x7362, even=0x5410, odd=0x7632)


def gv_transpose(a, b, c, d, sel=SELECTORS):
    """``gv_transpose``: four words of k rows k .. k + 3 (4 columns each)
    -> the 4 words of columns 0 .. 3, row k in the low byte."""
    lo01, hi01 = byte_perm(a, b, sel["lo"]), byte_perm(a, b, sel["hi"])
    lo23, hi23 = byte_perm(c, d, sel["lo"]), byte_perm(c, d, sel["hi"])
    return [byte_perm(lo01, lo23, sel["even"]),
            byte_perm(lo01, lo23, sel["odd"]),
            byte_perm(hi01, hi23, sel["even"]),
            byte_perm(hi01, hi23, sel["odd"])]


def lane_gt(lane):
    return lane >> 2, lane & 3


# The PTX ISA's fragments of mma.m16n8k16 with .s8 operands, lane (g, t):
# a register i of A (0, 1) holds A[g + 8 i][4 t + byte]; B's one register
# holds B[4 t + byte][g]; D register i (0..3) holds D[g + 8 (i // 2)]
# [2 t + i % 2].
def a_frag(lane, i, byte):
    g, t = lane_gt(lane)
    return g + 8 * i, 4 * t + byte


def b_frag(lane, byte):
    g, t = lane_gt(lane)
    return 4 * t + byte, g


def d_frag(lane, i):
    g, t = lane_gt(lane)
    return g + 8 * (i // 2), 2 * t + i % 2


def d_frag_permuted(lane, i):
    """A wrong D layout (registers 1 and 2 swapped), which the model must
    notice."""
    return d_frag(lane, (0, 2, 1, 3)[i])


def _bytes(words):
    """(..., ) uint32 -> (..., 4) int8, byte 0 first."""
    return words[..., None].view(np.uint8).reshape(words.shape + (4,)) \
        .view(np.int8)


def mma(a0, a1, b, d_map=d_frag):
    """D of one mma.sync m16n8k16 s8 per warp step: a0, a1, b (S, 32)
    uint32 registers -> (S, 32, 4) int64, placed by the fragment maps."""
    S = a0.shape[0]
    A = np.zeros((S, 16, 16), np.int64)
    B = np.zeros((S, 16, 8), np.int64)
    for lane in range(LANES):
        for i, reg in enumerate((a0, a1)):
            v = _bytes(reg[:, lane])
            for byte in range(4):
                A[(slice(None),) + a_frag(lane, i, byte)] = v[:, byte]
        v = _bytes(b[:, lane])
        for byte in range(4):
            B[(slice(None),) + b_frag(lane, byte)] = v[:, byte]
    D = A @ B
    return np.stack([np.stack([D[(slice(None),) + d_map(lane, i)]
                               for i in range(4)], -1)
                     for lane in range(LANES)], 1)


def tile_element(e):
    """Element e of a block's (register, lane) tile -> (row, column in the
    tile), as the kernel's writeout computes it."""
    r = (e >> 5) & 3
    return 2 * (e & 3) + (r & 1), 16 * ((e >> 2) & 7) + 2 * (e >> 7) + (r >> 1)


def owner(e, splits):
    """The reduce-scatter of a cluster of ``splits`` blocks: element e of
    the tile goes to block e // chunk, at offset e % chunk of the slot of
    the block that sends it."""
    chunk = -(-32 * LANES // splits)
    return e // chunk, e % chunk, chunk


def _warp_steps(plan, K):
    """(tile, split, warp, step) of every warp step the grid runs, and the
    split's end: the block of (tile, split) takes steps j of its split,
    warp w the steps j = w, w + GV_WARPS, ..."""
    out = []
    for bx in range(plan.grid[0]):
        for s, (kb, ke) in enumerate(_ranges(plan, K)):
            steps = -(-(ke - kb) // tqm.GV_KSTEP)
            for w in range(tqm.GV_WARPS):
                for j in range(w, steps, tqm.GV_WARPS):
                    out.append((bx, s, w, j, kb, ke))
    return np.array(out, np.int64).reshape(-1, 6)


def _model(xq, q, sel=SELECTORS, d_map=d_frag):
    """The kernel's int32 sums, (M, N) int64, from xq (M, K) and q (K, N)
    int8 numpy arrays."""
    M, K = xq.shape
    N = q.shape[1]
    plan = tqm.gemv_a8_plan(M, N, K)
    ws = _warp_steps(plan, K)
    bx, split, warp, j, kb, ke = ws.T
    lanes = np.arange(LANES)
    g, t = lanes >> 2, lanes & 3
    # lane's k rows k0 .. k0 + 3 and columns n .. n + 15
    k0 = kb[:, None] + tqm.GV_KSTEP * j[:, None] + 4 * t[None]     # (S, 32)
    n = bx[:, None] * tqm.GV_BN + 16 * g[None]
    rows = k0[..., None] + np.arange(4)                              # (S,32,4)
    cols = n[..., None] + np.arange(16)                              # (S,32,16)
    rin = rows < ke[:, None, None]
    cin = cols < N
    qp = np.zeros((K + 1, N + 1), np.int8)
    qp[:K, :N] = q
    piece = qp[np.where(rin, rows, K)[..., None],
               np.where(cin, cols, N)[..., None, :]]                 # (S,32,4,16)
    words = piece.view(np.uint8).reshape(piece.shape[:3] + (4, 4)) \
        .copy().view(np.uint32)[..., 0]                               # (S,32,4,4)
    xp = np.zeros((9, K + 1), np.int8)
    xp[:M, :K] = xq
    xr = np.where((g[None, :, None] < M) & rin, g[None, :, None], 8)
    xb = xp[xr, np.where(rin, rows, K)]                               # (S,32,4)
    xw = xb.view(np.uint8).copy().view(np.uint32)[..., 0]             # (S,32)
    col = []
    for i in range(4):
        col += gv_transpose(*(words[:, :, r, i] for r in range(4)), sel=sel)
    d = np.stack([mma(col[2 * p], col[2 * p + 1], xw, d_map)
                  for p in range(MMAS)], 2)                           # (S,32,8,4)
    # each warp's registers (4 p + i) by lane, summed over its steps and
    # over the block's warps: the block's tile, element e = 32 register +
    # lane
    reg = d.transpose(0, 2, 3, 1).reshape(len(ws), 32 * LANES)
    S = plan.grid[1]
    blocks = np.zeros((plan.grid[0], S, 32 * LANES), np.int64)
    np.add.at(blocks, (bx, split), reg)
    # the reduce-scatter: block `rank` sends element e to the slot
    # rank * chunk + e % chunk of block e // chunk, which adds its slots
    e = np.arange(32 * LANES)
    dest, off, chunk = owner(e, S)
    recv = np.zeros((plan.grid[0], S, S * chunk), np.int64)
    for rank in range(S):
        recv[:, dest, rank * chunk + off] = blocks[:, rank, e]
    tile = sum(recv[:, dest, rank * chunk + off] for rank in range(S))
    acc = np.zeros((M, plan.grid[0] * tqm.GV_BN), np.int64)
    for i in range(32 * LANES):
        m, c = tile_element(i)
        if m < M:
            acc[m, c::tqm.GV_BN] = tile[:, i]
    return acc[:, :N]


def test_tile_writeout_is_one_to_one():
    cells = {tile_element(e) for e in range(32 * LANES)}
    assert cells == {(m, c) for m in range(8) for c in range(tqm.GV_BN)}


@pytest.mark.parametrize("splits", range(1, tqm.GV_MAX_SPLITS + 1))
def test_reduce_scatter_covers_the_tile_once(splits):
    """Every element of the tile has one owner; the slots a block receives
    are distinct and fit the kernel's receive buffer (32 * 32 +
    GV_MAX_SPLITS words)."""
    slots = {}
    for rank in range(splits):
        for e in range(32 * LANES):
            dest, off, chunk = owner(e, splits)
            assert 0 <= dest < splits
            key = (dest, rank * chunk + off)
            assert key not in slots and key[1] < 32 * LANES + tqm.GV_MAX_SPLITS
            slots[key] = e
    for dest in range(splits):
        owned = {e for (d, _), e in slots.items() if d == dest}
        chunk = owner(0, splits)[2]
        assert owned == set(range(dest * chunk, min(32 * LANES,
                                                    (dest + 1) * chunk)))


def test_transpose_gives_columns():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 2 ** 32, size=(4, 5), dtype=np.uint64) \
        .astype(np.uint32)
    cols = gv_transpose(*rows)
    for i in range(4):
        want = sum(((rows[r] >> np.uint32(8 * i)) & np.uint32(0xFF))
                   .astype(np.uint64) << np.uint64(8 * r) for r in range(4))
        np.testing.assert_array_equal(cols[i], want.astype(np.uint32))


def _inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = rng.integers(-128, 128, size=(K, N)).astype(np.int8)
    s = (rng.random(N) * 0.01 + 1e-3).astype(np.float32)
    return x, q, s


MODEL_KN = [(2560, 2560), (1040, 384)] + RAGGED


@pytest.mark.parametrize("kn", MODEL_KN)
@pytest.mark.parametrize("M", [1, 3, 8])
def test_model_equals_the_exact_sums(M, kn):
    K, N = kn
    x, q, _ = _inputs(M, K, N, K * N + M)
    xq, _ = tptq.quantize_rowwise(torch.from_numpy(x))
    want = tqm.a8_accumulate_plain(xq, torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(_model(xq.numpy(), q), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kn", [(2560, 2560), (80, 200), (83, 96)])
def test_model_writeout_equals_the_jax_oracle(kn, dtype):
    """``float(acc) * sx * sw`` (``a8_out``) on the model's sums, rounded
    to the output type, equals ``repro.kernels.ref.quant_matmul_a8_ref``
    bit for bit (M = 8)."""
    K, N = kn
    x, q, s = _inputs(8, K, N, K + N)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xq, sx = tptq.quantize_rowwise(xt)
    acc = _model(xq.numpy(), q)
    out = (acc.astype(np.float32) * sx.numpy()) * s[None, :]
    got = torch.from_numpy(out.astype(np.float32)).to(xt.dtype)
    want = ref.quant_matmul_a8_ref(jnp.asarray(x).astype(dtype),
                                   jnp.asarray(q), jnp.asarray(s))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("fault", ["selector", "fragment"])
def test_model_notices_a_wrong_layout(fault):
    """The model can fail: a wrong byte-permute selector (the odd columns
    taken from the wrong half-words) or D's registers 1 and 2 swapped
    break the sums."""
    x, q, _ = _inputs(8, 256, 96, 7)
    xq, _ = tptq.quantize_rowwise(torch.from_numpy(x))
    want = tqm.a8_accumulate_plain(xq, torch.from_numpy(q)).numpy()
    if fault == "selector":
        got = _model(xq.numpy(), q, sel=dict(SELECTORS, odd=0x7610))
    else:
        got = _model(xq.numpy(), q, d_map=d_frag_permuted)
    assert not np.array_equal(got, want)
