"""The W8A8 wrapper's plan, a mirror of its tensor-core kernel's shared-memory
layout, and its plain version against the JAX package's oracle, on the CPU.

``quant_matmul.route`` with int8 xq sends M <= 8 to the skinny kernel, M > 8
to the int8 tensor-core kernel where the TMA can read the operands (K % 16
== 0, N % 16 == 0, 16-byte aligned bases), and the rest to the CUDA-core
tiled kernel.

The tensor-core kernel's integer ``wgmma`` reads both operands K-major, but
q is (K, N) with n contiguous, so each stage's raw weight tile (128 k rows of
128 n bytes, loaded plain by the TMA) is transposed in shared memory into a
K-major tile (128 n rows of 128 k bytes, 128B-swizzled).  The functions below mirror
``a8_raw_offset``, ``a8_kmajor_offset`` and ``a8_transpose`` of
``csrc/quant_matmul.cu`` line for line: the tile must land one to one, read
back as q, and neither the word reads nor the 16-byte writes of a warp may
fall on one bank twice.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.kernels import quant_matmul as tqm  # noqa: E402
from repro_torch.quant import ptq as tptq  # noqa: E402

I8 = torch.int8
TILE = 128
CONSUMERS = 256


def _layer_shapes(arch):
    """(K, N) of one layer's quantized matmuls: q, k, v, o, FFN up, down."""
    cfg = get_arch(arch)
    D, F = cfg.d_model, cfg.d_ff
    return [(D, cfg.n_heads * cfg.d_head), (D, cfg.n_kv_heads * cfg.d_head),
            (cfg.n_heads * cfg.d_head, D), (D, F), (F, D)]


# M of the serving paths at batch 8, s' = 512: a full-batch prefill, a
# one-row refill, a batch-4 calibration prefill, and decode
SERVING_M = {"prefill": 4096, "refill": 512, "calibration": 2048,
             "decode": 8}


@pytest.mark.parametrize("arch", ["bloom-3b", "bloom-7b1"])
@pytest.mark.parametrize("phase", sorted(SERVING_M))
def test_w8a8_serving_shapes_take_the_tensor_cores(arch, phase):
    M = SERVING_M[phase]
    for K, N in _layer_shapes(arch):
        assert tqm.route(M, K, N, I8, 8) == \
            ("skinny" if phase == "decode" else "tc"), (arch, K, N)


@pytest.mark.parametrize("case", [
    # (M, K, N, aligned, route)
    (1, 2560, 2560, True, "skinny"),
    (8, 10240, 2560, True, "skinny"),
    (8, 136, 200, False, "skinny"),
    (9, 16, 16, True, "tc"),
    (16, 128, 272, True, "tc"),
    (129, 144, 272, True, "tc"),              # a ragged last k stage
    (4096, 16384, 4096, True, "tc"),
    (129, 136, 272, True, "tiled"),           # K % 16 != 0
    (129, 2568, 2560, True, "tiled"),
    (129, 2560, 200, True, "tiled"),          # N % 16 != 0
    (16, 128, 40, True, "tiled"),
    (129, 128, 272, False, "tiled"),          # an unaligned base pointer
])
def test_route_a8(case):
    M, K, N, aligned, want = case
    assert tqm.route(M, K, N, I8, 8, aligned) == want


# -- a mirror of the kernel's tile layouts and transpose ---------------------


def raw_offset(k, n):
    """``a8_raw_offset``: byte of q[k, n] in the raw tile as the TMA writes
    it, plain."""
    return k * 128 + n


def kmajor_offset(n, kc):
    """``a8_kmajor_offset``: start of the 16-byte chunk kc (k 16 kc ..) of
    n row n in the K-major tile, XOR-swizzled by n % 8."""
    return n * 128 + ((kc ^ (n & 7)) << 4)


def byte_perm(x, y, s):
    """CUDA's ``__byte_perm``: byte i of the result is byte (s >> 4 i) & 7
    of the eight bytes of (y:x)."""
    src = (y << 32) | x
    return sum(((src >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def thread_share(ct):
    """(kc, n0) of consumer thread ct: columns n0 .. n0 + 3 over the k rows
    16 kc .. 16 kc + 15."""
    lane = ct & 31
    return (ct >> 5) ^ (lane & 7), 4 * lane


def transpose(raw, bt, ct):
    """``a8_transpose`` of consumer thread ct: raw and bt are bytearrays of
    the stage's raw and K-major tiles."""
    kc, n0 = thread_share(ct)
    r = [int.from_bytes(raw[raw_offset(16 * kc + t, n0):][:4], "little")
         for t in range(16)]
    col = [[0] * 4 for _ in range(4)]
    for j in range(4):
        lo01 = byte_perm(r[4 * j], r[4 * j + 1], 0x5140)
        hi01 = byte_perm(r[4 * j], r[4 * j + 1], 0x7362)
        lo23 = byte_perm(r[4 * j + 2], r[4 * j + 3], 0x5140)
        hi23 = byte_perm(r[4 * j + 2], r[4 * j + 3], 0x7362)
        col[0][j] = byte_perm(lo01, lo23, 0x5410)
        col[1][j] = byte_perm(lo01, lo23, 0x7632)
        col[2][j] = byte_perm(hi01, hi23, 0x5410)
        col[3][j] = byte_perm(hi01, hi23, 0x7632)
    for i in range(4):
        o = kmajor_offset(n0 + i, kc)
        bt[o:o + 16] = b"".join(w.to_bytes(4, "little") for w in col[i])


def test_byte_perm_4x4_transpose():
    rng = np.random.default_rng(0)
    words = [int(w) for w in rng.integers(0, 2 ** 32, size=4,
                                          dtype=np.uint64)]
    rows = [w.to_bytes(4, "little") for w in words]
    lo01 = byte_perm(words[0], words[1], 0x5140)
    lo23 = byte_perm(words[2], words[3], 0x5140)
    hi01 = byte_perm(words[0], words[1], 0x7362)
    hi23 = byte_perm(words[2], words[3], 0x7362)
    cols = [byte_perm(lo01, lo23, 0x5410), byte_perm(lo01, lo23, 0x7632),
            byte_perm(hi01, hi23, 0x5410), byte_perm(hi01, hi23, 0x7632)]
    for i, c in enumerate(cols):
        assert c.to_bytes(4, "little") == bytes(r[i] for r in rows)


def test_tile_offsets_are_one_to_one():
    raw = {raw_offset(k, n) for k in range(TILE) for n in range(TILE)}
    kmaj = {kmajor_offset(n, k >> 4) + (k & 15)
            for n in range(TILE) for k in range(TILE)}
    assert raw == kmaj == set(range(TILE * TILE))
    # the K-major tile is the wgmma's 128B-swizzled layout: within each
    # 1024-byte group of 8 n rows, row n's chunk c sits at chunk c ^ (n % 8)
    for n in range(TILE):
        for kc in range(8):
            off = kmajor_offset(n, kc)
            assert off // 1024 == n // 8 and (off % 1024) // 128 == n % 8
            assert (off % 128) // 16 == kc ^ (n % 8)


def test_thread_shares_cover_the_tile_once():
    shares = {thread_share(ct) for ct in range(CONSUMERS)}
    assert shares == {(kc, 4 * w) for kc in range(8) for w in range(32)}


def test_transpose_reads_back_q():
    rng = np.random.default_rng(1)
    q = rng.integers(-128, 128, size=(TILE, TILE)).astype(np.int8)
    raw, bt = bytearray(TILE * TILE), bytearray(TILE * TILE)
    qb = q.view(np.uint8)
    for k in range(TILE):
        for n in range(TILE):
            raw[raw_offset(k, n)] = int(qb[k, n])
    for ct in range(CONSUMERS):
        transpose(raw, bt, ct)
    got = np.empty_like(qb)
    for n in range(TILE):
        for k in range(TILE):
            got[k, n] = bt[kmajor_offset(n, k >> 4) + (k & 15)]
    np.testing.assert_array_equal(got.view(np.int8), q)


def _read_banks(warp, t):
    """The bank of each lane's word read at step t."""
    out = []
    for lane in range(32):
        kc, n0 = thread_share(32 * warp + lane)
        out.append((raw_offset(16 * kc + t, n0) // 4) % 32)
    return out


def test_transpose_is_free_of_bank_conflicts():
    """Each read step's 32 lanes read the 32 words of one row position (a
    lane's k chunk differs from its neighbours', its n word does not), so
    the raw tile needs no swizzle; each quarter warp's 16-byte writes cover
    the 8 chunk positions of the K-major tile's swizzled rows."""
    for warp in range(CONSUMERS // 32):
        for t in range(16):
            assert len(set(_read_banks(warp, t))) == 32
        for i in range(4):
            for quarter in range(4):
                chunks = set()
                for lane in range(8 * quarter, 8 * quarter + 8):
                    kc, n0 = thread_share(32 * warp + lane)
                    chunks.add((kmajor_offset(n0 + i, kc) % 128) // 16)
                assert len(chunks) == 8


# -- the plain version against the JAX package's oracle ----------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kn", sorted(set(_layer_shapes("bloom-3b"))))
def test_a8_plain_bitwise_vs_reference(kn, dtype):
    """``quant_matmul_a8_plain`` on the port's rowwise-quantized x equals
    ``repro.kernels.ref.quant_matmul_a8_ref`` bit for bit at a BLOOM-3B
    layer shape, M = 144."""
    K, N = kn
    rng = np.random.default_rng(K + N)
    x = rng.standard_normal((144, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    t = tptq.quantize(torch.from_numpy(w), 8, act_bits=8)
    q, s = t.q, t.scale.reshape(-1)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xq, sx = tptq.quantize_rowwise(xt)
    got = tqm.quant_matmul_a8_plain(xq, sx, q, s, xt.dtype)
    want = ref.quant_matmul_a8_ref(jnp.asarray(x).astype(dtype),
                                   jnp.asarray(q.numpy()),
                                   jnp.asarray(s.numpy()))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
