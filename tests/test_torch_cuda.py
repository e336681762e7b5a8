"""The port's CUDA kernels against their plain versions, on the card.

Every test that launches a kernel takes the ``cuda`` fixture, which skips
where there is no card; this file imports no JAX, so it runs as it is on a
machine with a card and only PyTorch (README, "On the GPU").  The
tests at the end need no card: they check that the kernel wrappers refuse
what the kernels do not take.

Tolerances: float32 kernels sum in another order than cuBLAS, so they are
held at rtol = atol = 1e-4 (the inputs are O(1) and K <= 10240).  bfloat16
outputs are rounded from float32 sums on both sides, so they may differ by
one bfloat16 ulp of the output (rtol 2^-7) plus the float32 summation
error (atol 1e-4).  W8A8 sums integers exactly and is compared bitwise.
The fused tier (K6, K7) is held the same way for k1 and v1; its output o
is a sum of per-head partials rounded head by head, and with a8 of an
int8 re-quantization of float32 attention values, which ``_fused_tols``
bounds; K7 must equal K6 bitwise on the same values.  The decode loop on
the device (a captured step in the WHILE node of ``csrc/decode_loop.cu``)
is held bitwise to ``generate_reference`` and to itself, and a step at a
device position bitwise to the step a host int drove (the kernels with
scalar n_valid / evict), on every tier.  The recurrent, hybrid and audio
families run no kernel: their captured step is held bitwise to the eager
step, to ``generate_reference`` and to itself, and their refilled rows to
the same prompt refilled alone.  Training (float weights, no kernel) is
held to the CPU within ``TRAIN_TOL`` (``TRAIN_TOL_LATER`` for grad_norm
after the first update), and remat on to remat off.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

from repro_torch.kernels import decode_glue as tdg  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quant_matmul as tqm  # noqa: E402
from repro_torch.quant import ptq as tptq  # noqa: E402

MKN = [(3, 80, 200), (8, 256, 96), (1, 64, 33), (17, 128, 40),
       (8, 2560, 10240), (96, 2560, 256)]
BF16_TOL = dict(rtol=2 ** -7, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mm_inputs(M, K, N, bits, device, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    t = tptq.quantize(w, bits)
    return x.to(device), t.q.to(device), t.scale.reshape(-1).to(device)


def _decode_inputs(B, nh, nkv, dh, W, device, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, nh, dh), (B, W, nkv, dh), (B, W, nkv, dh))]
    nv = rng.integers(1, W + 1, size=(B,)).astype(np.int32)
    return [torch.from_numpy(a).to(device) for a in arrs + [nv]]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mkn", MKN)
def test_quant_matmul_cuda_vs_plain(cuda, mkn, bits):
    x, q, s = _mm_inputs(*mkn, bits, cuda)
    got = tqm.quant_matmul_cuda(x, q, s, bits)
    torch.testing.assert_close(got, tqm.quant_matmul_plain(x, q, s, bits),
                               rtol=1e-4, atol=1e-4)
    xb = x.to(torch.bfloat16)
    got = tqm.quant_matmul_cuda(xb, q, s, bits)
    torch.testing.assert_close(got, tqm.quant_matmul_plain(xb, q, s, bits),
                               **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", MKN)
def test_quant_matmul_a8_cuda_bitwise(cuda, mkn):
    x, q, s = _mm_inputs(*mkn, 8, cuda)
    xq, sx = tptq.quantize_rowwise(x)
    for dt in (torch.float32, torch.bfloat16):
        got = tqm.quant_matmul_a8_cuda(xq, sx, q, s, dt)
        assert torch.equal(got, tqm.quant_matmul_a8_plain(xq, sx, q, s, dt))


# the tensor-core path (bf16, M > 8): M in {16, 129, 520, 4096}, N a
# multiple of 16 but not of 128 (272) and BLOOM-3B's 2560 / 10240, K in
# {64, 80, 2560, 10240} and 72 (36 packed int4 rows: a ragged last stage)
TC_MKN = [(16, 64, 272), (129, 80, 272), (520, 2560, 2560),
          (4096, 2560, 10240), (4096, 10240, 2560), (129, 2560, 10240),
          (16, 10240, 272), (520, 72, 2560), (4096, 64, 272)]


def _bf16_mm_inputs(M, K, N, bits, device, seed=0):
    """x in bf16 and weights from normal / sqrt(K): outputs of order 1 at
    every K, which the tolerance's atol assumes."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, N)) / np.sqrt(K))
                         .astype(np.float32))
    t = tptq.quantize(w, bits)
    return (x.to(torch.bfloat16).to(device), t.q.to(device),
            t.scale.reshape(-1).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mkn", TC_MKN)
def test_quant_matmul_tensor_core_vs_plain(cuda, mkn, bits):
    M, K, N = mkn
    assert tqm.route(M, K, N, torch.bfloat16, bits) == "tc"
    x, q, s = _bf16_mm_inputs(M, K, N, bits, cuda)
    ops.reset_launch_counts()
    got = tqm.quant_matmul_cuda(x, q, s, bits)
    name = "w4a16" if bits == 4 else "w8a16"
    counts = ops.launch_counts()
    assert counts[name + "_tc"] == counts[name] == 1
    torch.testing.assert_close(got, tqm.quant_matmul_plain(x, q, s, bits),
                               **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_tensor_core_rows_invariant_and_deterministic(cuda,
                                                                   bits):
    """A row's output does not depend on M, and two calls are equal."""
    x, q, s = _bf16_mm_inputs(4096, 2560, 2560, bits, cuda, seed=3)
    full = tqm.quant_matmul_cuda(x, q, s, bits)
    assert torch.equal(full, tqm.quant_matmul_cuda(x, q, s, bits))
    for m in (512, 136):
        assert torch.equal(full[:m],
                           tqm.quant_matmul_cuda(x[:m].contiguous(), q, s,
                                                 bits))


# W8A8 on the tensor cores (int8 xq, M > 8): M in {16, 129, 520, 4096}, N in
# {272, 2560, 10240}, K in {128, 144, 2560, 10240} (144: a ragged last
# stage), every combination, both output types, bitwise
A8_TC_MKN = [(M, K, N) for M in (16, 129, 520, 4096)
             for K in (128, 144, 2560, 10240) for N in (272, 2560, 10240)]


def _a8_inputs(M, K, N, device, seed=0):
    x, q, s = _bf16_mm_inputs(M, K, N, 8, device, seed)
    xq, sx = tptq.quantize_rowwise(x)
    return xq, sx, q, s


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", A8_TC_MKN)
def test_quant_matmul_a8_tensor_core_bitwise(cuda, mkn):
    M, K, N = mkn
    assert tqm.route(M, K, N, torch.int8, 8) == "tc"
    xq, sx, q, s = _a8_inputs(M, K, N, cuda)
    for dt in (torch.bfloat16, torch.float32):
        ops.reset_launch_counts()
        got = tqm.quant_matmul_a8_cuda(xq, sx, q, s, dt)
        counts = ops.launch_counts()
        assert counts["w8a8_tc"] == counts["w8a8"] == 1
        assert torch.equal(got, tqm.quant_matmul_a8_plain(xq, sx, q, s, dt))
        # and a second call, bitwise
        assert torch.equal(got, tqm.quant_matmul_a8_cuda(xq, sx, q, s, dt))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (M, K, N, offset of xq in elements): K % 16 != 0, N % 16 != 0, an
    # unaligned xq
    (129, 136, 272, 0), (520, 2568, 2560, 0), (129, 2560, 200, 0),
    (16, 128, 40, 0), (129, 128, 272, 8)])
def test_quant_matmul_a8_tiled_shapes_still_bitwise(cuda, case):
    M, K, N, off = case
    xq, sx, q, s = _a8_inputs(M, K, N, cuda, seed=6)
    buf = torch.empty(M * K + off, dtype=torch.int8, device=cuda)
    xo = buf[off:].view(M, K)
    xo.copy_(xq)
    assert tqm.route(M, K, N, torch.int8, 8, xo.data_ptr() % 16 == 0) \
        == "tiled"
    for dt in (torch.bfloat16, torch.float32):
        ops.reset_launch_counts()
        got = tqm.quant_matmul_a8_cuda(xo, sx, q, s, dt)
        counts = ops.launch_counts()
        assert counts["w8a8"] == 1 and counts["w8a8_tc"] == 0
        assert torch.equal(got, tqm.quant_matmul_a8_plain(xo, sx, q, s, dt))


@pytest.mark.cuda
def test_ops_w8a8_prefill_takes_the_tensor_cores(cuda):
    x, q, s = _bf16_mm_inputs(64, 256, 512, 8, cuda, seed=7)
    ops.reset_launch_counts()
    got = ops.quant_matmul(x, q, s, 8, act_bits=8)
    counts = ops.launch_counts()
    assert counts["w8a8_tc"] == counts["w8a8"] == 1
    xq, sx = tptq.quantize_rowwise(x)
    assert torch.equal(got, tqm.quant_matmul_a8_plain(xq, sx, q, s,
                                                      torch.bfloat16))


# the W8A8 GEMV (qmm_a8_gemv, M <= 8): BLOOM-3B's and BLOOM-7B1's decode
# shapes (K, N), and ragged ones its byte-load instantiation takes (N % 16
# != 0, K % 4 != 0); (256, 96) takes 16-byte loads over two splits
GEMV_KN = [(2560, 2560), (2560, 10240), (10240, 2560), (4096, 4096),
           (4096, 16384), (16384, 4096), (80, 200), (64, 33), (256, 96),
           (83, 96), (33, 64)]


def _gemv_inputs(M, K, N, device, seed=0):
    """int8 weights over the full range (-128 included), positive scales,
    and xq, sx from ``quantize_rowwise`` of a bf16 x."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-128, 128, size=(K, N), dtype=np.int8))
    s = torch.from_numpy((rng.random(N) * 0.01 + 1e-3).astype(np.float32))
    xq, sx = tptq.quantize_rowwise(x.to(torch.bfloat16).to(device))
    return xq, sx, q.to(device), s.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kn", GEMV_KN)
@pytest.mark.parametrize("M", [1, 2, 3, 7, 8])
def test_quant_matmul_a8_gemv_bitwise(cuda, M, kn):
    K, N = kn
    xq, sx, q, s = _gemv_inputs(M, K, N, cuda, seed=K + N + M)
    assert tqm.gemv_wide(xq, q) == (N % 16 == 0 and K % 4 == 0)
    for dt in (torch.bfloat16, torch.float32):
        ops.reset_launch_counts()
        got = tqm.quant_matmul_a8_cuda(xq, sx, q, s, dt)
        counts = ops.launch_counts()
        assert counts["w8a8_gemv"] == counts["w8a8"] == 1
        assert counts["w8a8_tc"] == 0
        assert torch.equal(got, tqm.quant_matmul_a8_plain(xq, sx, q, s, dt))


@pytest.mark.cuda
@pytest.mark.parametrize("kn", [(2560, 2560), (256, 96)])
@pytest.mark.parametrize("offsets", [(1, 0), (0, 1), (4, 16), (3, 5)])
def test_quant_matmul_a8_gemv_unaligned_bases(cuda, kn, offsets):
    """xq and q sliced to start off a 16-byte boundary: the byte-load
    instantiation where 16-byte pieces or 4-byte words cannot be read,
    bitwise equal all the same."""
    K, N = kn
    off_x, off_q = offsets
    xq, sx, q, s = _gemv_inputs(8, K, N, cuda, seed=11)
    bx = torch.empty(8 * K + off_x, dtype=torch.int8, device=cuda)
    xo = bx[off_x:].view(8, K)
    xo.copy_(xq)
    bq = torch.empty(K * N + off_q, dtype=torch.int8, device=cuda)
    qo = bq[off_q:].view(K, N)
    qo.copy_(q)
    assert tqm.gemv_wide(xo, qo) == (off_x % 4 == 0 and off_q % 16 == 0)
    for dt in (torch.bfloat16, torch.float32):
        got = tqm.quant_matmul_a8_cuda(xo, sx, qo, s, dt)
        assert torch.equal(got, tqm.quant_matmul_a8_plain(xq, sx, q, s, dt))


@pytest.mark.cuda
@pytest.mark.parametrize("kn", [(2560, 2560), (10240, 2560), (4096, 16384),
                                (80, 200)])
def test_quant_matmul_a8_gemv_rows_invariant_and_deterministic(cuda, kn):
    """Row r of an M = 8 call equals the same row computed alone; two
    calls are equal, and so are an eager call and a CUDA-graph replay."""
    K, N = kn
    xq, sx, q, s = _gemv_inputs(8, K, N, cuda, seed=5)
    full = tqm.quant_matmul_a8_cuda(xq, sx, q, s, torch.float32)
    assert torch.equal(full, tqm.quant_matmul_a8_cuda(xq, sx, q, s,
                                                      torch.float32))
    for r in range(8):
        alone = tqm.quant_matmul_a8_cuda(xq[r:r + 1].contiguous(),
                                         sx[r:r + 1].contiguous(), q, s,
                                         torch.float32)
        assert torch.equal(alone[0], full[r]), r
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tqm.quant_matmul_a8_cuda(xq, sx, q, s, torch.float32)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = tqm.quant_matmul_a8_cuda(xq, sx, q, s, torch.float32)
    for _ in range(2):
        replayed.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, full)


@pytest.mark.cuda
def test_w8a8_gemv_counts_every_call_at_m_le_8(cuda):
    for M in (1, 4, 8, 9, 16):
        xq, sx, q, s = _gemv_inputs(M, 256, 128, cuda, seed=M)
        ops.reset_launch_counts()
        got = tqm.quant_matmul_a8_cuda(xq, sx, q, s, torch.bfloat16)
        counts = ops.launch_counts()
        assert counts["w8a8"] == 1
        assert counts["w8a8_gemv"] == int(M <= 8), M
        assert torch.equal(got, tqm.quant_matmul_a8_plain(
            xq, sx, q, s, torch.bfloat16))


# the W8A16 / W4A16 GEMV (qmm_a16_gemv, bf16 x at M <= 8): BLOOM-3B's and
# BLOOM-7B1's decode shapes (K, N), and 16-column-aligned ragged ones (K not
# a multiple of a step or of a split, N not of 128; odd K at bits 8 only)
A16_GEMV_KN = [(2560, 2560), (2560, 10240), (10240, 2560), (4096, 4096),
               (4096, 16384), (16384, 4096), (80, 208), (1040, 400),
               (256, 96), (34, 64), (83, 96)]


def _a16_gemv_cases(kns):
    return [(bits, K, N) for bits in (8, 4) for K, N in kns
            if bits == 8 or K % 2 == 0]


def _a16_gemv_inputs(M, K, N, bits, device, seed=0):
    """bf16 x; weights over their full range (every int8 value, every
    nibble), scales that keep the outputs of order 1."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    rows = (K + 1) // 2 if bits == 4 else K
    q = torch.from_numpy(rng.integers(-128, 128, size=(rows, N),
                                      dtype=np.int8))
    mean_sq = 21.5 if bits == 4 else 5461.5           # E[q^2] of the values
    s = torch.from_numpy(((rng.random(N) + 0.5) / np.sqrt(K * mean_sq))
                         .astype(np.float32))
    return (x.to(torch.bfloat16).to(device), q.to(device), s.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("bits,K,N", _a16_gemv_cases(A16_GEMV_KN))
@pytest.mark.parametrize("M", [1, 3, 8])
def test_quant_matmul_a16_gemv_vs_plain(cuda, M, bits, K, N):
    x, q, s = _a16_gemv_inputs(M, K, N, bits, cuda, seed=K + N + M + bits)
    assert tqm.route(M, K, N, torch.bfloat16, bits) == "skinny"
    assert tqm.gemv_a16_wide(x, q, bits)
    name = "w4a16" if bits == 4 else "w8a16"
    ops.reset_launch_counts()
    got = tqm.quant_matmul_cuda(x, q, s, bits)
    counts = ops.launch_counts()
    assert counts[name + "_gemv"] == counts[name] == 1
    assert counts[name + "_tc"] == 0
    torch.testing.assert_close(got, tqm.quant_matmul_plain(x, q, s, bits),
                               **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,K,N", _a16_gemv_cases(
    [(2560, 2560), (10240, 2560), (4096, 16384), (1040, 400), (83, 96)]))
def test_quant_matmul_a16_gemv_rows_invariant_and_deterministic(cuda, bits,
                                                                K, N):
    """Row r of an M = 8 call equals the same row computed alone, bitwise;
    two calls are equal, and so are an eager call and a CUDA-graph
    replay."""
    x, q, s = _a16_gemv_inputs(8, K, N, bits, cuda, seed=5)
    full = tqm.quant_matmul_cuda(x, q, s, bits)
    assert torch.equal(full, tqm.quant_matmul_cuda(x, q, s, bits))
    for r in range(8):
        alone = tqm.quant_matmul_cuda(x[r:r + 1].contiguous(), q, s, bits)
        assert torch.equal(alone[0], full[r]), r
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tqm.quant_matmul_cuda(x, q, s, bits)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = tqm.quant_matmul_cuda(x, q, s, bits)
    for _ in range(2):
        replayed.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, full)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (M, K, N, x dtype, bits, offset of x, offset of q in elements): float32
    # x, x or q off its boundary, N % 16 != 0, odd K at bits 4
    (8, 2560, 2560, torch.float32, 8, 0, 0),
    (8, 2560, 2560, torch.float32, 4, 0, 0),
    (8, 2560, 256, torch.bfloat16, 8, 1, 0),
    (8, 2560, 256, torch.bfloat16, 4, 1, 0),
    (3, 256, 96, torch.bfloat16, 8, 0, 4),
    (3, 256, 96, torch.bfloat16, 4, 0, 8),
    (8, 80, 200, torch.bfloat16, 8, 0, 0),
    (8, 83, 96, torch.bfloat16, 4, 0, 0)])
def test_quant_matmul_narrow_decode_calls_stay_on_skinny(cuda, case):
    """What 16-byte loads cannot read, and float32 x, stay on qmm_skinny,
    within the same tolerances as before."""
    M, K, N, dt, bits, off_x, off_q = case
    x, q, s = _a16_gemv_inputs(M, K, N, bits, cuda, seed=9)
    bx = torch.empty(x.numel() + off_x, dtype=dt, device=cuda)
    xo = bx[off_x:].view(M, K)
    xo.copy_(x)
    bq = torch.empty(q.numel() + off_q, dtype=torch.int8, device=cuda)
    qo = bq[off_q:].view(q.shape)
    qo.copy_(q)
    name = "w4a16" if bits == 4 else "w8a16"
    ops.reset_launch_counts()
    got = tqm.quant_matmul_cuda(xo, qo, s, bits)
    counts = ops.launch_counts()
    assert counts[name] == 1 and counts[name + "_gemv"] == 0
    torch.testing.assert_close(got, tqm.quant_matmul_plain(xo, q, s, bits),
                               **(BF16_TOL if dt == torch.bfloat16
                                  else dict(rtol=1e-4, atol=1e-4)))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_a16_gemv_counts_every_wide_bf16_call_at_m_le_8(cuda, bits):
    name = "w4a16" if bits == 4 else "w8a16"
    for M in (1, 4, 8, 9, 16):
        x, q, s = _a16_gemv_inputs(M, 256, 128, bits, cuda, seed=M)
        ops.reset_launch_counts()
        got = tqm.quant_matmul_cuda(x, q, s, bits)
        counts = ops.launch_counts()
        assert counts[name] == 1
        assert counts[name + "_gemv"] == int(M <= 8), M
        torch.testing.assert_close(got, tqm.quant_matmul_plain(x, q, s,
                                                               bits),
                                   **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (M, K, N, x dtype, bits, offset of x in elements): the plan's tiled
    # shapes -- K % 8 != 0, N % 16 != 0, float32 x, an unaligned x
    (129, 84, 272, torch.bfloat16, 8, 0),
    (129, 81, 272, torch.bfloat16, 4, 0),
    (129, 80, 200, torch.bfloat16, 4, 0),
    (129, 2560, 256, torch.float32, 8, 0),
    (129, 80, 272, torch.bfloat16, 8, 1)])
def test_quant_matmul_tiled_shapes_still_pass(cuda, case):
    M, K, N, dt, bits, off = case
    x, q, s = _bf16_mm_inputs(M, K, N, bits, cuda, seed=5)
    buf = torch.empty(M * K + off, dtype=dt, device=cuda)
    xo = buf[off:].view(M, K)
    xo.copy_(x)
    assert tqm.route(M, K, N, dt, bits, xo.data_ptr() % 16 == 0) == "tiled"
    ops.reset_launch_counts()
    got = tqm.quant_matmul_cuda(xo, q, s, bits)
    counts = ops.launch_counts()
    assert counts["w4a16" if bits == 4 else "w8a16"] == 1
    assert counts["w8a16_tc"] == counts["w4a16_tc"] == 0
    want = tqm.quant_matmul_plain(xo, q, s, bits)
    torch.testing.assert_close(got, want, **(
        BF16_TOL if dt == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)))


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("dh", [64, 80])
def test_flash_decode_cuda_vs_plain(cuda, G, dh):
    q, k, v, nv = _decode_inputs(3, 2 * G, 2, dh, 130, cuda)
    got = tfd.flash_decode_cuda(q, k, v, nv)
    torch.testing.assert_close(got, tfd.flash_decode_plain(q, k, v, nv),
                               rtol=1e-4, atol=1e-4)
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    torch.testing.assert_close(tfd.flash_decode_cuda(*bf, 57),
                               tfd.flash_decode_plain(*bf, 57), **BF16_TOL)


@pytest.mark.cuda
def test_flash_decode_cuda_at_a_zamba2_site(cuda):
    """K4 at a published Zamba2 site's shape (B = 8, 32 heads of 224 over
    32, W = 640, per-row n_valid 513-640) and scale (224 / 2)^-1/2, float32
    and bf16, against the plain version within K4's limits above; with no
    scale, K4 at BLOOM-3B's 32 x 80 takes 1/sqrt(d_head) as before: the
    same bits as that float passed as the scale."""
    scale = (224 / 2) ** -0.5
    q, k, v, _ = _decode_inputs(8, 32, 32, 224, 640, cuda, seed=3)
    nv = torch.tensor([513, 640, 576, 600, 520, 639, 577, 612],
                      dtype=torch.int32, device=cuda)
    got = tfd.flash_decode_cuda(q, k, v, nv, scale)
    torch.testing.assert_close(got, tfd.flash_decode_plain(q, k, v, nv,
                                                           scale),
                               rtol=1e-4, atol=1e-4)
    assert float((tfd.flash_decode_cuda(q, k, v, nv) - got).abs().max()) \
        > 1e-3
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    torch.testing.assert_close(tfd.flash_decode_cuda(*bf, nv, scale),
                               tfd.flash_decode_plain(*bf, nv, scale),
                               **BF16_TOL)
    q, k, v, nv = _decode_inputs(8, 32, 32, 80, 640, cuda, seed=4)
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    assert torch.equal(tfd.flash_decode_cuda(*bf, nv),
                       tfd.flash_decode_cuda(*bf, nv, 1.0 / 80 ** 0.5))


def _paged_inputs(B, nh, nkv, dh, n_b, bt, device, tail=None, seed=0):
    """q, k/v pages of a shuffled arena (P = B * n_b + 2, possibly with a
    wider (nkv', dh') tail, returned as the leading-corner view), a table
    mapping each row's blocks to distinct pages, and ragged n_valid."""
    rng = np.random.default_rng(seed)
    P = B * n_b + 2
    nkv_t, dh_t = tail or (nkv, dh)
    q = rng.standard_normal((B, nh, dh)).astype(np.float32)
    kp = rng.standard_normal((P, bt, nkv_t, dh_t)).astype(np.float32)
    vp = rng.standard_normal((P, bt, nkv_t, dh_t)).astype(np.float32)
    table = (2 + rng.permutation(B * n_b)).reshape(B, n_b).astype(np.int32)
    nv = rng.integers(1, n_b * bt + 1, size=(B,)).astype(np.int32)
    t = [torch.from_numpy(a).to(device) for a in (q, kp, vp, table, nv)]
    return t[0], t[1][..., :nkv, :dh], t[2][..., :nkv, :dh], t[3], t[4]


def _gathered(pages, table):
    B, n_b = table.shape
    g = pages[table.long()]
    return g.reshape((B, n_b * pages.shape[1]) + tuple(g.shape[3:]))


@pytest.mark.cuda
@pytest.mark.parametrize("G,dh,bt", [(1, 80, 16), (1, 80, 8), (4, 64, 16),
                                     (2, 80, 32)])
def test_flash_decode_paged_cuda_vs_plain(cuda, G, dh, bt):
    q, kp, vp, table, nv = _paged_inputs(3, 2 * G, 2, dh, 10, bt, cuda)
    for n_valid in (nv, 10 * bt, 1, bt + 3):
        got = tfd.flash_decode_paged_cuda(q, kp, vp, table, n_valid)
        torch.testing.assert_close(
            got, tfd.flash_decode_paged_plain(q, kp, vp, table, n_valid),
            rtol=1e-4, atol=1e-4)
    bf = [t.to(torch.bfloat16) for t in (q, kp, vp)]
    torch.testing.assert_close(
        tfd.flash_decode_paged_cuda(*bf, table, nv),
        tfd.flash_decode_paged_plain(*bf, table, nv), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_paged_bitwise_equals_slab_kernel(cuda, dtype):
    """K5 walks the same tiles in the same order as K4: on the same logical
    values the two are bitwise equal."""
    q, kp, vp, table, nv = (t.to(dtype) if t.is_floating_point() else t
                            for t in _paged_inputs(4, 4, 4, 80, 12, 16, cuda))
    ks, vs = _gathered(kp, table), _gathered(vp, table)
    for n_valid in (nv, 12 * 16, 100):
        assert torch.equal(
            tfd.flash_decode_paged_cuda(q, kp, vp, table, n_valid),
            tfd.flash_decode_cuda(q, ks, vs, n_valid))


@pytest.mark.cuda
def test_flash_decode_paged_reads_a_wider_tail_in_place(cuda):
    """A (32, 128)-tail arena read through its [..., :4, :80] corner: the
    strided view goes to the kernel as it is."""
    q, kp, vp, table, nv = _paged_inputs(3, 4, 4, 80, 6, 16, cuda,
                                         tail=(8, 128))
    assert not kp.is_contiguous()
    got = tfd.flash_decode_paged_cuda(q, kp, vp, table, nv)
    torch.testing.assert_close(
        got, tfd.flash_decode_paged_plain(q, kp, vp, table, nv),
        rtol=1e-4, atol=1e-4)
    assert torch.equal(got, tfd.flash_decode_paged_cuda(
        q, kp.contiguous(), vp.contiguous(), table, nv))


def _split_nv(W, B, rng):
    """n_valid at the split boundaries, the whole window, and ragged."""
    S = tfd.SPLIT
    ragged = torch.from_numpy(rng.integers(1, W + 1, size=(B,)).astype(
        np.int32))
    return [1, S - 1, S, S + 1, W, ragged]


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 4, 7, 12])
@pytest.mark.parametrize("dh", [64, 80, 128])
def test_flash_decode_split_kv_vs_plain_and_paged_bitwise(cuda, G, dh):
    """K4 and K5 against their plain versions at every GQA group the
    configs use (BLOOM 1; 2 and 4; deepseek-coder-33b 7, mistral-large 12)
    and n_valid on each side of a split boundary; K5 bitwise equal to K4
    on the gathered slab for 8-, 16- and 32-slot pages."""
    B, nkv, W = 3, 2, 384
    rng = np.random.default_rng(G * 1000 + dh)
    for bt in (8, 16, 32):
        q, kp, vp, table, _ = _paged_inputs(B, G * nkv, nkv, dh, W // bt,
                                            bt, cuda, seed=bt)
        ks, vs = _gathered(kp, table), _gathered(vp, table)
        for n_valid in _split_nv(W, B, rng):
            if isinstance(n_valid, torch.Tensor):
                n_valid = n_valid.to(cuda)
            for dt, tol in ((torch.float32, dict(rtol=1e-4, atol=1e-4)),
                            (torch.bfloat16, BF16_TOL)):
                qd, kd, vd, ksd, vsd = (t.to(dt) for t in (q, kp, vp, ks, vs))
                got4 = tfd.flash_decode_cuda(qd, ksd, vsd, n_valid)
                torch.testing.assert_close(
                    got4, tfd.flash_decode_plain(qd, ksd, vsd, n_valid), **tol)
                got5 = tfd.flash_decode_paged_cuda(qd, kd, vd, table, n_valid)
                torch.testing.assert_close(
                    got5, tfd.flash_decode_paged_plain(qd, kd, vd, table,
                                                       n_valid), **tol)
                assert torch.equal(got5, got4), (bt, n_valid, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("G,dh", [(1, 80), (4, 128), (7, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_rows_invariant_and_deterministic(cuda, G, dh, dtype):
    """A row's output is a function of its own q, slots and n_valid: the
    same bits computed alone (B = 1), inside B = 8, and over a wider cache
    (W = 1024 holding the same first 640 slots); two calls agree."""
    B, nkv, W, W2 = 8, 2, 640, 1024
    q, k, v, _ = _decode_inputs(B, G * nkv, nkv, dh, W2, cuda, seed=G)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    rng = np.random.default_rng(dh)
    nv = torch.from_numpy(rng.integers(1, W + 1, size=(B,)).astype(
        np.int32)).to(cuda)
    nv[:4] = torch.tensor([1, tfd.SPLIT, tfd.SPLIT + 1, W], dtype=torch.int32)
    ks, vs = k[:, :W].contiguous(), v[:, :W].contiguous()
    full = tfd.flash_decode_cuda(q, ks, vs, nv)
    assert torch.equal(full, tfd.flash_decode_cuda(q, ks, vs, nv))
    assert torch.equal(full, tfd.flash_decode_cuda(q, k, v, nv))
    for r in range(B):
        alone = tfd.flash_decode_cuda(q[r:r + 1], ks[r:r + 1], vs[r:r + 1],
                                      nv[r:r + 1].clone())
        assert torch.equal(alone[0], full[r]), r
        assert torch.equal(alone[0], tfd.flash_decode_cuda(
            q[r:r + 1], ks[r:r + 1], vs[r:r + 1], int(nv[r]))[0]), r


@pytest.mark.cuda
def test_ops_route_cuda_tensors_to_the_kernels(cuda):
    x, q, s = _mm_inputs(4, 128, 64, 8, cuda)
    w = tptq.QTensor(q, s.reshape(1, -1), 8, (128, 64), torch.float32, 8)
    ops.reset_launch_counts()
    ops.qmatmul(x.reshape(2, 2, 128), w)
    qd, kd, vd, nv = _decode_inputs(2, 4, 4, 80, 16, cuda)
    ops.flash_decode(qd, kd, vd, nv)
    qp, kp, vp, table, nvp = _paged_inputs(2, 4, 4, 80, 3, 8, cuda)
    ops.flash_decode_paged(qp, kp, vp, table, nvp)
    counts = ops.launch_counts()
    assert counts["w8a8"] == 1 and counts["flash_decode"] == 1
    assert counts["flash_decode_paged"] == 1
    assert counts["w8a16"] == counts["w4a16"] == 0


# -- the decode glue (csrc/decode_glue.cu): add_norm, rope_qk_write --------

# (D, norm, weighted): BLOOM-3B, BLOOM-7B1, qwen3-1.7b, OLMo-1B
GLUE_NORMS = [(2560, "layernorm", True), (4096, "layernorm", True),
              (2048, "rmsnorm", True), (2048, "nonparam_ln", False)]
# (nh, nkv, dh): BLOOM-3B, BLOOM-7B1, qwen3-1.7b (G = 2)
GLUE_HEADS = [(32, 32, 80), (32, 32, 128), (16, 8, 128)]
GLUE_W, GLUE_BT = 640, 16          # s' 512 + n_max 128; the arena's pages


def _rand(shape, device, dtype=torch.bfloat16, seed=0, scale=1.0,
          shift=0.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32) * scale + shift
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _assert_ulps(got, want, what):
    """got within one ulp of want in their type (bfloat16: 2^-7 of the
    larger magnitude's binade; float32 kernels sum in another order and are
    held at 1e-5)."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        return
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    bad = (g - w).abs() > ulp
    assert not bad.any(), (f"{what}: {int(bad.sum())} elements beyond one "
                           f"bf16 ulp, max |diff| "
                           f"{float((g - w).abs().max()):.3g}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_y", [True, False], ids=["add", "no_add"])
@pytest.mark.parametrize("D,kind,weighted", GLUE_NORMS)
def test_add_norm_cuda_vs_plain(cuda, D, kind, weighted, with_y, dtype):
    """x_new bitwise PyTorch's add, h within one ulp of the op chain; a
    row's result alone equals it in a batch of 8, and a second call equals
    the first; one launch a call."""
    x = _rand((8, 1, D), cuda, dtype, 0, shift=0.3)
    y = _rand((8, 1, D), cuda, dtype, 1, scale=2.0) if with_y else None
    w = _rand((D,), cuda, dtype, 2, scale=0.1, shift=1.0) if weighted \
        else None
    ops.reset_launch_counts()
    got_x, got_h = ops.add_norm(x, y, w, kind)
    assert ops.launch_counts()["add_norm"] == 1
    want_x, want_h = tdg.add_norm_plain(x, y, w, kind)
    assert torch.equal(got_x, want_x)
    _assert_ulps(got_h, want_h, f"add_norm {kind} D={D}")
    one_x, one_h = tdg.add_norm_cuda(x[3:4], None if y is None else y[3:4],
                                     w, kind)
    assert torch.equal(one_x, got_x[3:4]) and torch.equal(one_h, got_h[3:4])
    again = tdg.add_norm_cuda(x, y, w, kind)
    assert torch.equal(again[0], got_x) and torch.equal(again[1], got_h)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
@pytest.mark.parametrize("pos", [0, GLUE_BT, GLUE_W - 1])
@pytest.mark.parametrize("nh,nkv,dh", GLUE_HEADS)
def test_rope_qk_write_cuda_vs_plain(cuda, nh, nkv, dh, pos, paged):
    """q and the cache's k within one bf16 ulp of the op chain, v copied
    bitwise, only the token's slot (page) written, at positions 0, a page
    edge and W - 1; a device position and a host int give the same bits;
    one launch a call."""
    B, W, bt = 8, GLUE_W, GLUE_BT
    q = _rand((B, 1, nh, dh), cuda, seed=pos)
    k = _rand((B, 1, nkv, dh), cuda, seed=pos + 1)
    v = _rand((B, 1, nkv, dh), cuda, seed=pos + 2)
    ck = _rand((B, W, nkv, dh), cuda, seed=3)
    cv = _rand((B, W, nkv, dh), cuda, seed=4)
    freqs = tdg.rope_table(dh, 1e4, cuda)
    if paged:
        rng = np.random.default_rng(5)
        n_b = W // bt
        table = torch.from_numpy((2 + rng.permutation(B * n_b)).reshape(
            B, n_b).astype(np.int32)).to(cuda)
        arenas = []
        for c in (ck, cv):
            a = torch.zeros((B * n_b + 2, bt, max(nkv, 32), 128),
                            dtype=c.dtype, device=cuda)
            a[table.long(), :, :nkv, :dh] = c.reshape(B, n_b, bt, nkv, dh)
            arenas.append(a)
        index = (table[:, pos // bt].long(),
                 torch.full((B,), pos % bt, dtype=torch.long, device=cuda))
    else:
        table, arenas = None, [ck, cv]
        index = torch.tensor([pos % W], device=cuda)

    def views(arenas):
        return [a[..., :nkv, :dh] for a in arenas] if paged else arenas

    def run(pos_arg):
        got = [a.clone() for a in arenas]
        ops.reset_launch_counts()
        q_out = tdg.rope_qk_write_cuda(q, k, v, pos_arg, freqs, *views(got),
                                       table)
        assert ops.launch_counts()["rope_qk_write"] == 1
        return q_out, got

    q_got, got = run(torch.tensor(pos, dtype=torch.int32, device=cuda))
    q_host, got_host = run(pos)
    assert torch.equal(q_host, q_got)
    assert all(torch.equal(a, b) for a, b in zip(got, got_host))
    want = [a.clone() for a in arenas]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=cuda)
    q_want = tdg.rope_qk_write_plain(q, k, v, positions, *views(want), index,
                                     1e4)
    _assert_ulps(q_got, q_want, "q")
    for name, g, w, a in zip("kv", got, want, arenas):
        changed = (g != a).any(dim=(-2, -1))
        hit = torch.zeros_like(changed)
        if paged:
            hit[index] = True
        else:
            hit[:, pos % W] = True
        assert not (changed & ~hit).any(), f"{name}: another slot changed"
        if name == "v":
            assert torch.equal(g, w)
        else:
            _assert_ulps(g, w, "k")


@pytest.mark.cuda
def test_captured_bloom3b_generate_takes_the_glue_kernels(cuda):
    """Full-width BLOOM-3B at W8A16 (short prompts and caps): generate's
    captured loop equals generate_reference token for token; its step
    holds at most 600 kernel nodes (about 2,300 as op chains) and launches
    add_norm 2L + 1 and rope_qk_write L times a step."""
    import gc
    from repro_torch.config import get_arch
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(get_arch("bloom-3b"), batch_capacity=8, s_max=64,
                        n_max=16, quant_bits=8, seed=2, device="cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 250000, size=n).tolist()
               for n in (5, 64, 9, 33, 1, 17, 48, 2)]
    caps = [16, 3, 9, 16, 1, 12, 16, 7]
    a = eng.generate(prompts, caps)
    b = eng.generate_reference(prompts, caps)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    L = eng.cfg.n_layers
    loop = eng._gen.graphs[eng._canon_bits(8)]
    assert loop.launches["add_norm"] == 2 * L + 1
    assert loop.launches["rope_qk_write"] == L
    assert loop.launches["flash_decode"] == L
    assert eng.captures[-1]["nodes"] <= 600, eng.captures[-1]
    del eng, loop
    gc.collect()
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_paged_engine_equals_slab_engine_on_the_card(cuda):
    from repro_torch.serving.engine import tiny_engine
    from repro_torch.serving.kv_arena import KVArena
    eng = tiny_engine("bloom-3b", batch_capacity=3, s_max=16, n_max=12,
                      quant_bits=8, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (5, 16, 9)]
    want = eng.generate(prompts, [12, 4, 7])
    ops.reset_launch_counts()
    for k in (1, 5):
        arena = KVArena.for_engines(eng, block_tokens=4)
        got = eng.generate_via_chunks(prompts, [12, 4, 7], k=k, arena=arena)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_array_equal(got.lengths, want.lengths)
        assert arena.free_pages == arena.total_pages
    assert ops.launch_counts()["flash_decode_paged"] > 0


@pytest.mark.cuda
def test_generate_on_the_card_is_deterministic(cuda):
    from repro_torch.serving.engine import tiny_engine
    eng = tiny_engine("bloom-3b", batch_capacity=3, s_max=16, n_max=12,
                      quant_bits=8, use_kernel=True, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (5, 16, 9)]
    for bits in (8, (8, 8), 4):
        a = eng.generate(prompts, [12, 4, 7], quant_bits=bits)
        b = eng.generate_reference(prompts, [12, 4, 7], quant_bits=bits)
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.lengths, b.lengths)
        c = eng.generate(prompts, [12, 4, 7], quant_bits=bits)
        np.testing.assert_array_equal(a.tokens, c.tokens)


@pytest.mark.cuda
def test_plain_decode_attention_is_refused_on_the_card(cuda):
    from repro_torch.serving.engine import tiny_engine
    with pytest.raises(ValueError, match="CPU only"):
        tiny_engine("bloom-3b", use_kernel=False, device="cuda")
    eng = tiny_engine("bloom-3b", batch_capacity=2, s_max=8, n_max=4,
                      device="cuda")
    tokens = torch.ones((2, 8), dtype=torch.int32, device=cuda)
    _, cache = eng._prefill(eng.params, tokens)
    with pytest.raises(ValueError, match="CPU only"):
        eng.model.decode_step(eng.params, cache, tokens[:, :1], 8,
                              use_kernel=False)


def _fused_inputs(B, D, G, nkv, dh, act_bits, device, seed=0):
    """x (B, D) and the operands of K6 after it: the four int8 projections
    with their flat scales (a list of 8 tensors)."""
    rng = np.random.default_rng(seed)
    nh = G * nkv
    x = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    ws = []
    for shape in ((D, nh * dh), (D, nkv * dh), (D, nkv * dh), (nh * dh, D)):
        w = rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[0])
        t = tptq.quantize(torch.from_numpy(w), 8, act_bits=act_bits)
        ws += [t.q.to(device), t.scale.reshape(-1).to(device)]
    return x.to(device), ws


def _fused_slab_and_pages(x, W, nkv, dh, bt, device, tail=None, seed=0):
    """A pre-write slab k/v (B, W, nkv, dh) and the same values in a
    shuffled page arena (possibly with a wider tail, returned as the
    corner view), with its table."""
    rng = np.random.default_rng(seed)
    B, n_b = x.shape[0], W // bt
    ck, cv = (torch.from_numpy(rng.standard_normal(
        (B, W, nkv, dh)).astype(np.float32)).to(device) for _ in range(2))
    P = B * n_b + 2
    nkv_t, dh_t = tail or (nkv, dh)
    table = torch.from_numpy((2 + rng.permutation(B * n_b)).reshape(
        B, n_b).astype(np.int32)).to(device)
    pages = []
    for c in (ck, cv):
        p = torch.zeros((P, bt, nkv_t, dh_t), device=device)
        p[table.long(), :, :nkv, :dh] = c.reshape(B, n_b, bt, nkv, dh)
        pages.append(p[..., :nkv, :dh])
    return ck, cv, pages[0], pages[1], table


def _fused_tols(dt, a8, ws, v_cache, want):
    """(o, k1, v1) tolerances of K6/K7 against their plain versions: k1
    and v1 are rounded once (the matmul tolerances); o sums per-head
    partials in x's type head by head (bf16: atol 2^-6 max|o|, an ulp at
    the output's largest magnitude); with a8 each side quantizes the
    attention row to int8 from float32 values that differ in their last
    bits, so two elements may land one step apart, each moving o by at
    most max|v| / 127 * max|wo|."""
    flip = 0.0
    if a8:
        vmax = max(float(v_cache.abs().max()), float(want[2].abs().max()))
        flip = 2 * vmax / 127 * float((ws[6].abs().float() * ws[7]).max())
    if dt == torch.float32:
        kv = dict(rtol=1e-4, atol=1e-4)
        return dict(rtol=1e-4, atol=1e-4 + flip), kv, kv
    o_atol = 2 ** -6 * float(want[0].float().abs().max()) + flip
    return dict(rtol=2 ** -7, atol=o_atol), BF16_TOL, BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("act_bits", [16, 8])
@pytest.mark.parametrize("pos", [0, 37, 64, 71])
@pytest.mark.parametrize("G,dh", [(1, 128), (2, 128), (1, 80), (2, 32)])
def test_flash_decode_fused_cuda_vs_plain(cuda, G, dh, pos, act_bits):
    """K6 and K7 against their plain versions at pos 0 (no valid slot), a
    partial fill, a full cache and the eviction slot (W = 64), in float32
    (1e-4) and bfloat16; K7 bitwise equal to K6 on the same values."""
    x, ws = _fused_inputs(3, 256, G, 2, dh, act_bits, cuda, seed=pos)
    W = 64
    ck, cv, kp, vp, table = _fused_slab_and_pages(x, W, 2, dh, 16, cuda)
    nv, ev = min(pos, W), (pos % W if pos >= W else -1)
    cos, sin = ops._rope_rows(pos, dh, 1e4, cuda)
    a8 = act_bits == 8
    for dt in (torch.float32, torch.bfloat16):
        xd, ckd, cvd, kpd, vpd = (t.to(dt) for t in (x, ck, cv, kp, vp))
        got = tfd.flash_decode_fused_cuda(xd, *ws, ckd, cvd, nv, ev, cos,
                                          sin, True, a8)
        want = tfd.flash_decode_fused_plain(xd, *ws, ckd, cvd, nv, ev, cos,
                                            sin, True, a8)
        for g, w, tol in zip(got, want, _fused_tols(dt, a8, ws, cvd, want)):
            torch.testing.assert_close(g, w, **tol)
        paged = tfd.flash_decode_fused_paged_cuda(xd, *ws, kpd, vpd, table,
                                                  nv, ev, cos, sin, True, a8)
        for p, g in zip(paged, got):
            assert torch.equal(p, g)


@pytest.mark.cuda
def test_flash_decode_fused_paged_reads_a_wider_tail_in_place(cuda):
    x, ws = _fused_inputs(3, 128, 1, 2, 128, 16, cuda)
    *_, kp, vp, table = _fused_slab_and_pages(x, 64, 2, 128, 16, cuda,
                                              tail=(4, 160))
    assert not kp.is_contiguous()
    cos, sin = ops._rope_rows(40, 128, 1e4, cuda)
    got = tfd.flash_decode_fused_paged_cuda(x, *ws, kp, vp, table, 40, -1,
                                            cos, sin)
    want = tfd.flash_decode_fused_paged_plain(x, *ws, kp, vp, table, 40, -1,
                                              cos, sin)
    for g, w, tol in zip(got, want, _fused_tols(torch.float32, False, ws, vp,
                                                want)):
        torch.testing.assert_close(g, w, **tol)
    again = tfd.flash_decode_fused_paged_cuda(
        x, *ws, kp.contiguous(), vp.contiguous(), table, 40, -1, cos, sin)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("act_bits", [16, 8])
@pytest.mark.parametrize("dh", [32, 80, 128])
@pytest.mark.parametrize("G", [1, 2, 7, 12])
def test_flash_decode_fused_gqa_and_batches_vs_plain(cuda, G, dh, act_bits):
    """K6 and K7 against their plain versions at the GQA group sizes of the
    queued configs, B 1/3/8/9 (9: two launches of 8 rows) and positions 0,
    37, 64 (a full window) and 71 (the eviction slot), float32 and
    bfloat16; K7 bitwise equal to K6 on the same values."""
    W, a8 = 64, act_bits == 8
    for B in (1, 3, 8, 9):
        x, ws = _fused_inputs(B, 256, G, 2, dh, act_bits, cuda, seed=B + G)
        ck, cv, kp, vp, table = _fused_slab_and_pages(x, W, 2, dh, 16, cuda,
                                                      seed=dh)
        for pos in (0, 37, 64, 71):
            nv, ev = min(pos, W), (pos % W if pos >= W else -1)
            cos, sin = ops._rope_rows(pos, dh, 1e4, cuda)
            for dt in (torch.float32, torch.bfloat16):
                xd, ckd, cvd, kpd, vpd = (t.to(dt)
                                          for t in (x, ck, cv, kp, vp))
                got = tfd.flash_decode_fused_cuda(xd, *ws, ckd, cvd, nv, ev,
                                                  cos, sin, True, a8)
                want = tfd.flash_decode_fused_plain(xd, *ws, ckd, cvd, nv,
                                                    ev, cos, sin, True, a8)
                for g, w, tol in zip(got, want,
                                     _fused_tols(dt, a8, ws, cvd, want)):
                    torch.testing.assert_close(g, w, **tol)
                paged = tfd.flash_decode_fused_paged_cuda(
                    xd, *ws, kpd, vpd, table, nv, ev, cos, sin, True, a8)
                for p, g in zip(paged, got):
                    assert torch.equal(p, g)


@pytest.mark.cuda
@pytest.mark.parametrize("act_bits", [16, 8])
@pytest.mark.parametrize("G,dh", [(1, 128), (7, 32), (2, 80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_fused_rows_invariant_and_deterministic(cuda, G, dh,
                                                             act_bits, dtype):
    """Each row's (o, k1, v1) is bitwise the same alone and in a batch of 9
    (per-row n_valid and evict tensors); two calls are equal, and so is a
    CUDA-graph replay; K7 equals K6 bitwise, also through a wider page
    tail's corner."""
    W, B, a8 = 64, 9, act_bits == 8
    x, ws = _fused_inputs(B, 256, G, 2, dh, act_bits, cuda, seed=G * dh)
    x = x.to(dtype)
    ck, cv, kp, vp, table = _fused_slab_and_pages(
        x, W, 2, dh, 16, cuda, tail=(3, dh + 16), seed=1)
    ck, cv = ck.to(dtype), cv.to(dtype)
    kp, vp = (t._base.to(dtype)[..., :2, :dh] for t in (kp, vp))
    assert not kp.is_contiguous()
    nv = torch.tensor([0, 37, 64, 64, 20, 64, 5, 64, 33], dtype=torch.int32,
                      device=cuda)
    ev = torch.tensor([-1, -1, 7, -1, -1, 63, -1, 0, -1], dtype=torch.int32,
                      device=cuda)
    cos, sin = ops._rope_rows(37, dh, 1e4, cuda)

    def k6(lo=0, hi=B):
        return tfd.flash_decode_fused_cuda(
            x[lo:hi].contiguous(), *ws, ck[lo:hi].contiguous(),
            cv[lo:hi].contiguous(), nv[lo:hi].contiguous(),
            ev[lo:hi].contiguous(), cos, sin, True, a8)

    full = k6()
    for b in range(B):
        for f, r in zip(full, k6(b, b + 1)):
            assert torch.equal(f[b:b + 1], r), b
    for f, r in zip(full, k6()):
        assert torch.equal(f, r)
    paged = tfd.flash_decode_fused_paged_cuda(x, *ws, kp, vp, table, nv, ev,
                                              cos, sin, True, a8)
    for f, p in zip(full, paged):
        assert torch.equal(f, p)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k6()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = k6()
    graph.replay()
    torch.cuda.synchronize()
    for f, c in zip(full, captured):
        assert torch.equal(f, c)


@pytest.mark.cuda
def test_fused_engine_on_the_card(cuda):
    """Reduced float32 BLOOM-7B1 (d_head 128) on the card takes the fused
    tier at W8A16 and W8A8: generate == generate_reference, paged ==
    generate, through K6 and K7."""
    from repro_torch.config import get_arch
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_arena import KVArena
    cfg = get_arch("bloom-7b1").scaled(n_layers=2, d_model=256, n_heads=2,
                                       n_kv_heads=2, d_ff=512, vocab=512,
                                       dtype="float32")
    eng = ServingEngine(cfg, batch_capacity=3, s_max=16, n_max=12,
                        quant_bits=8, device="cuda")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (5, 16, 9)]
    for bits in (8, (8, 8)):
        assert eng.decode_tier(bits) == "fused"
        ops.reset_launch_counts()
        a = eng.generate(prompts, [12, 4, 7], quant_bits=bits)
        b = eng.generate_reference(prompts, [12, 4, 7], quant_bits=bits)
        np.testing.assert_array_equal(a.tokens, b.tokens)
        arena = KVArena.for_engines(eng, block_tokens=4)
        c = eng.generate_via_chunks(prompts, [12, 4, 7], k=5,
                                    quant_bits=bits, arena=arena)
        np.testing.assert_array_equal(a.tokens, c.tokens)
        counts = ops.launch_counts()
        assert counts["flash_decode_fused"] > 0
        assert counts["flash_decode_fused_paged"] > 0
        assert counts["flash_decode"] == counts["flash_decode_paged"] == 0
        # the norm half of the decode glue only: K6/K7 do their own rope
        assert counts["add_norm"] > 0 and counts["rope_qk_write"] == 0


# -- the decode position on the device: bitwise the host-int step ---------
# Shared with tests/test_torch_decode_graph.py, which runs the same cases
# on the CPU (the kernels' plain versions).

POS_KW = dict(batch_capacity=4, s_max=24, n_max=8)
# 0, s_max, W - 1, W and W + 7 (W = s_max + n_max: the fused tier's
# eviction slot past the end)
POSITIONS = [0, 24, 31, 32, 39]
# (arch, precision): BLOOM-3B's unfused tier, K1 + K4, K2 + K4 and K3 + K4
# (K5 paged); BLOOM-7B1 at d_head 128, the fused tier K6 (K7 paged)
TIERS = [("bloom-3b", 8), ("bloom-3b", (8, 8)), ("bloom-3b", 4),
         ("bloom-7b1", 8), ("bloom-7b1", (8, 8))]


def _pos_engine(arch, dtype, device):
    from repro_torch.config import get_arch
    from repro_torch.serving.engine import ServingEngine
    dims = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                vocab=256)
    if arch == "bloom-7b1":
        dims.update(d_model=256, d_ff=256)
    eng = ServingEngine(get_arch(arch).scaled(**dims, dtype=dtype),
                        quant_bits=8, seed=3, device=device, **POS_KW)
    assert eng.decode_tier() == ("fused" if arch == "bloom-7b1" else "flash")
    return eng


def host_int_attention(p, cfg, x, ck, cv, pos: int):
    """The decode attention a host-int position drove before the position
    moved to the device: Python-int cache slot, valid counts, evicted slot
    and rope angles (``freqs * float(pos)``), the kernels taking them as
    scalars on CUDA (rope_qk_write its position), or their plain versions
    on the CPU."""
    B, W = x.shape[0], ck.shape[1]
    cuda = x.is_cuda
    if ops.fusable_decode(p, cfg):
        ws = []
        for name in ("wq", "wk", "wv", "wo"):
            ws += [p[name].q, p[name].scale.reshape(-1)]
        cos, sin = ops._rope_rows(pos, cfg.d_head, cfg.rope_theta, x.device)
        fused = tfd.flash_decode_fused_cuda if cuda \
            else tfd.flash_decode_fused_plain
        o, k1, v1 = fused(x[:, 0].contiguous(), *ws, ck, cv, min(pos, W),
                          pos % W if pos >= W else -1, cos, sin, True,
                          p["wq"].act_bits == 8)
        ck[:, pos % W] = k1.to(ck.dtype)
        cv[:, pos % W] = v1.to(cv.dtype)
        return o[:, None]
    from repro_torch.models import common
    q, k1, v1 = common.qkv_proj(p, cfg, x, None, use_rope=False)
    if cuda:
        q = tdg.rope_qk_write_cuda(
            q, k1, v1, pos, tdg.rope_table(cfg.d_head, cfg.rope_theta,
                                           x.device), ck, cv)
    else:
        positions = torch.full((B, 1), pos, dtype=torch.int32)
        q = tdg.rope_qk_write_plain(q, k1, v1, positions, ck, cv,
                                    torch.tensor([pos % W]), cfg.rope_theta)
    attend = tfd.flash_decode_cuda if cuda else tfd.flash_decode_plain
    out = attend(q[:, 0].contiguous(), ck, cv, min(pos + 1, W))[:, None]
    return common.mm(out.reshape(B, 1, cfg.n_heads * cfg.d_head), p["wo"])


def host_int_step(cfg, params, cache, tokens, pos: int):
    """The host-int decode step (its layers around ``host_int_attention``,
    each residual add with the norm after it through ``add_norm``) over a
    slab cache, updated in place; returns the logits."""
    from repro_torch.models import common, transformer
    x = transformer._table(params)[tokens]
    norm = tdg.add_norm_cuda if x.is_cuda else tdg.add_norm_plain
    norms = [lp["norm1"] for lp in params["layers"]] + [params["final_norm"]]
    x, h = norm(x, None, norms[0], cfg.norm)
    for l, (lp, layer) in enumerate(zip(params["layers"], cache)):
        x, h = norm(x, host_int_attention(lp["attn"], cfg, h, layer["k"],
                                          layer["v"], pos),
                    lp["norm2"], cfg.norm)
        x, h = norm(x, common.ffn_apply(lp["ffn"], cfg, h), norms[l + 1],
                    cfg.norm)
    return transformer._unembed(cfg, params, h)[:, 0]


def _pos_inputs(eng, seed):
    """A random slab cache (B, W, nkv, dh) per layer and a token per row."""
    from repro_torch.models import common
    rng = np.random.default_rng(seed)
    shape = (4, eng.cache_len, eng.cfg.n_kv_heads, eng.cfg.d_head)
    cache = [{n: torch.from_numpy(rng.standard_normal(shape)
                                  .astype(np.float32))
              .to(common.torch_dtype(eng.cfg)).to(eng.device)
              for n in ("k", "v")} for _ in range(eng.cfg.n_layers)]
    tokens = torch.from_numpy(rng.integers(1, 256, (4, 1))).to(eng.device)
    return cache, tokens


def check_device_position_step(arch, bits, dtype, pos, device):
    """``decode_step`` at an int32 position tensor on the device against
    the host-int step: logits and cache writes bitwise equal."""
    import copy
    eng = _pos_engine(arch, dtype, device)
    params = eng.params_for(bits)
    cache, tokens = _pos_inputs(eng, seed=0)
    want_cache = copy.deepcopy(cache)
    want = host_int_step(eng.cfg, params, want_cache, tokens, pos)
    got, _ = eng.model.decode_step(
        params, cache, tokens,
        torch.tensor(pos, dtype=torch.int32).to(eng.device))
    assert torch.equal(got, want)
    for a, b in zip(cache, want_cache):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def check_paged_device_position_step(arch, bits, dtype, pos, device):
    """``decode_step_paged`` at a device position, each row on pages of
    its own in a shuffled order (K5, or K7 on the fused tier), against the
    host-int step on the same values as a slab: bitwise (K5 == K4 and
    K7 == K6 on the gathered slab)."""
    eng = _pos_engine(arch, dtype, device)
    params = eng.params_for(bits)
    cache, tokens = _pos_inputs(eng, seed=1)
    bt = 8
    n_b = eng.cache_len // bt
    rng = np.random.default_rng(2)
    table = torch.from_numpy((rng.permutation(4 * n_b) + 2).reshape(
        4, n_b).astype(np.int32)).to(eng.device)
    pages = {}
    for name in ("k", "v"):
        leaf = torch.zeros((eng.cfg.n_layers, 4 * n_b + 2, bt,
                            eng.cfg.n_kv_heads, eng.cfg.d_head),
                           dtype=cache[0][name].dtype, device=eng.device)
        for l, layer in enumerate(cache):
            leaf[l][table.long().reshape(-1)] = layer[name].reshape(
                4 * n_b, bt, *layer[name].shape[2:])
        pages[name] = leaf
    want = host_int_step(eng.cfg, params, cache, tokens, pos)
    got, _ = eng.model.decode_step_paged(
        params, pages, table, tokens,
        torch.tensor(pos, dtype=torch.int32).to(eng.device))
    assert torch.equal(got, want)
    for l, layer in enumerate(cache):
        for name in ("k", "v"):
            assert torch.equal(pages[name][l][table.long()].reshape(
                layer[name].shape), layer[name])


@pytest.mark.cuda
@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,bits", TIERS)
def test_device_position_step_is_bitwise_on_the_card(cuda, arch, bits,
                                                     dtype, pos):
    check_device_position_step(arch, bits, dtype, pos, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pos", POSITIONS[:3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,bits", TIERS)
def test_paged_device_position_step_is_bitwise_on_the_card(cuda, arch,
                                                           bits, dtype, pos):
    check_paged_device_position_step(arch, bits, dtype, pos, "cuda")


# -- the decode loop on the device: a captured step in a WHILE node -------


def _loop_engine(eos_id=0, n_max=128):
    """Reduced bfloat16 BLOOM-3B (d_head 32: the unfused tier, the bf16
    GEMVs at decode) with a long loop."""
    from repro_torch.config import get_arch
    from repro_torch.serving.engine import ServingEngine
    cfg = get_arch("bloom-3b").scaled(n_layers=2, d_model=128, n_heads=4,
                                      n_kv_heads=4, d_ff=512, vocab=512)
    return ServingEngine(cfg, batch_capacity=4, s_max=16, n_max=n_max,
                         quant_bits=8, seed=4, eos_id=eos_id, device="cuda")


def _loop_prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, size=n).tolist() for n in (5, 16, 9, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [0, 8, (8, 8), 4])
def test_replayed_generate_equals_reference(cuda, bits):
    from repro_torch.kernels.decode_loop import DeviceLoop
    eng = _loop_engine()
    prompts, caps = _loop_prompts(), [128, 40, 97, 3]
    ops.reset_launch_counts()
    a = eng.generate(prompts, caps, quant_bits=bits)
    loop = eng._gen.graphs[eng._canon_bits(bits)]
    assert isinstance(loop, DeviceLoop)
    steps = int(a.lengths.max())
    assert int(loop.iters) == loop.counted == steps
    # the decode launches: each iteration's, and the warm-up step's
    counts = ops.launch_counts()
    assert loop.launches["flash_decode"] == 2
    assert counts["flash_decode"] == 2 * (steps + 1)
    b = eng.generate_reference(prompts, caps, quant_bits=bits)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.lengths, b.lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16, 128])
def test_replayed_chunked_equals_generate(cuda, k):
    eng = _loop_engine()
    prompts, caps = _loop_prompts(1), [128, 40, 97, 3]
    want = eng.generate(prompts, caps)
    got = eng.generate_via_chunks(prompts, caps, k=k)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)


@pytest.mark.cuda
def test_replayed_paged_equals_slab_with_a_refill_at_40(cuda):
    from repro_torch.serving.kv_arena import KVArena
    eng = _loop_engine()
    prompts, caps = _loop_prompts(2), [128, 60, 97, 70]
    want = eng.generate(prompts, caps)

    def run(arena):
        st = eng.start_chunked(prompts[:2], caps[:2], arena=arena)
        st = eng.generate_chunked(st, 40)
        _, _, _, t = eng.poll_chunked(st)
        assert t == 40
        st = eng.refill_chunked(st, [2, 3], prompts[2:], caps[2:], t_now=t)
        while True:
            st = eng.generate_chunked(st, 16)
            out, lengths, done, t = eng.poll_chunked(st)
            if eng.exhausted(lengths, done, st.caps_host, t):
                break
        if arena is not None:
            eng.release_all(st)
        return out, lengths

    arena = KVArena.for_engines(eng, block_tokens=16)
    (so, sl), (po, pl) = run(None), run(arena)
    np.testing.assert_array_equal(po, so)
    np.testing.assert_array_equal(pl, sl)
    np.testing.assert_array_equal(so[:2], want.tokens[:2])
    assert arena.free_pages == arena.total_pages
    paged = eng.generate_via_chunks(prompts, caps, k=16, arena=arena)
    np.testing.assert_array_equal(paged.tokens, want.tokens)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_replayed_loop_stops_where_the_reference_loop_stops(cuda, paged):
    """An EOS that row 0 emits at step 3: the device loop runs as many
    iterations as ``generate_reference``'s loop, and the chunked ``t``
    is that count."""
    from repro_torch.serving.kv_arena import KVArena
    prompts, caps = _loop_prompts(3), [128, 6, 5, 0]
    eos = int(_loop_engine().generate_reference(prompts, caps).tokens[0, 3])
    eng = _loop_engine(eos_id=eos)
    ref = eng.generate_reference(prompts, caps)
    steps = int(ref.lengths.max())
    assert ref.lengths[0] <= 4 and steps < 128
    got = eng.generate(prompts, caps)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_array_equal(got.lengths, ref.lengths)
    assert eng._gen.graphs[8].counted == steps
    arena = KVArena.for_engines(eng, block_tokens=16) if paged else None
    st = eng.generate_chunked(eng.start_chunked(prompts, caps, arena=arena),
                              128)
    out, lengths, done, t = eng.poll_chunked(st)
    assert t == steps and st.graphs[8].counted == steps
    np.testing.assert_array_equal(out, ref.tokens)
    if paged:
        eng.release_all(st)


@pytest.mark.cuda
def test_two_replays_of_the_same_state_are_bitwise_equal(cuda):
    eng = _loop_engine(eos_id=-1)           # no row stops before its cap
    prompts, caps = _loop_prompts(4), [128] * 4
    runs = []
    for _ in range(2):
        st = eng.generate_chunked(eng.start_chunked(prompts, caps), 64)
        out, lengths, done, t = eng.poll_chunked(st)
        runs.append((out, lengths, t, st.cur.clone(),
                     [c["k"].clone() for c in st.cache]))
    (o1, l1, t1, c1, k1), (o2, l2, t2, c2, k2) = runs
    np.testing.assert_array_equal(o1, o2)
    np.testing.assert_array_equal(l1, l2)
    assert t1 == t2 == 64 and torch.equal(c1, c2)
    assert all(torch.equal(a, b) for a, b in zip(k1, k2))


@pytest.mark.cuda
def test_a_capture_after_every_cohort_drained(cuda):
    """The engine keeps its graph pool in use across drained cohorts: each
    cohort captures its step anew after the last one was released and
    freed (the pool's last graph used to go with it, and the next capture
    failed ``use_count > 0``), and serves the same tokens."""
    import gc

    from repro_torch.serving.kv_arena import KVArena
    eng = _loop_engine()
    prompts, caps = _loop_prompts(5), [40, 40, 40, 40]
    arena = KVArena.for_engines(eng, block_tokens=16)
    outs = []
    for _ in range(3):
        st = eng.start_chunked(prompts, caps, arena=arena)
        st = eng.generate_chunked(st, 64)
        outs.append(eng.poll_chunked(st)[0])
        eng.release_all(st)
        del st
        gc.collect()
    assert len(eng.captures) == 3 and eng._gen is None
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
    assert arena.free_pages == arena.total_pages


def _bloom3b_engine():
    """Full-width BLOOM-3B at W8A16, B = 8, s' = 512, n_max = 128, no EOS
    (every row decodes 128 tokens)."""
    from repro_torch.config import get_arch
    from repro_torch.serving.engine import ServingEngine
    return ServingEngine(get_arch("bloom-3b"), batch_capacity=8, s_max=512,
                         n_max=128, quant_bits=8, eos_id=-1, seed=0,
                         device="cuda")


@pytest.mark.cuda
def test_device_intervals_cover_a_generate(cuda):
    """The tracer's device intervals of a full-width BLOOM-3B ``generate``
    (prefill, the device loop, the read-back), placed on the host clock,
    lie inside the call's host span in that order, and prefill plus
    decode come within 3 % of the call's synchronised host time."""
    import time

    from repro_torch.serving import trace
    eng = _bloom3b_engine()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, eng.cfg.vocab, size=512).tolist()
               for _ in range(8)]
    for _ in range(2):                  # capture, then an anchor to place by
        eng.generate(prompts, [128] * 8)
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompts, [128] * 8)
        t1 = time.perf_counter()
        recs = [r for r in trace.records() if trace._end(r) >= t0]
        iv = {r.name: r for r in recs if isinstance(r, trace.Interval)}
        assert sorted(iv) == ["dev.decode", "dev.prefill", "dev.read_back"]
        pre, dec, back = iv["dev.prefill"], iv["dev.decode"], \
            iv["dev.read_back"]
        eps = 50e-6
        assert t0 - eps <= pre.t0 < pre.t1 <= dec.t0 + eps
        assert dec.t0 < dec.t1 <= back.t0 + eps < back.t1 <= t1 + eps
        assert [r.value for r in recs if isinstance(r, trace.Count)
                and r.name == "iters"] == [128]
        dev_s = (pre.t1 - pre.t0) + (dec.t1 - dec.t0)
        assert abs(dev_s - (t1 - t0)) <= 0.03 * (t1 - t0), (dev_s, t1 - t0)
    del eng


@pytest.mark.cuda
def test_anchor_places_device_events_within_50us(cuda):
    """Each read-back ends in an anchor, an event recorded with its host
    time on a stream a blocking copy left idle.  Placed from the one
    before it (its host time plus the events' elapsed time), an anchor
    lands within 50 us of its own host time, across device work and host
    sleeps between them; an interval's start is never placed before the
    host recorded it (less 50 us).  The card's gauges come from NVML."""
    import time

    from repro_torch.serving import trace
    x = torch.randn(2048, 2048, device=cuda)
    dev = torch.cuda.current_device()
    with trace.read_back(cuda):
        x[0, 0].cpu()
    errs, lags = [], []
    for i in range(6):
        h1, a1 = trace._T.anchors[dev]
        time.sleep(0.01 * i)
        h0 = time.perf_counter()
        with trace.device("probe", cuda):
            for _ in range(20):
                x = torch.tanh(x @ x)
        time.sleep(0.005)
        with trace.read_back(cuda):
            x[0, 0].cpu()
        h2, a2 = trace._T.anchors[dev]
        a2.synchronize()
        errs.append(h1 + a1.elapsed_time(a2) * 1e-3 - h2)
        probe = [r for r in trace.records()
                 if isinstance(r, trace.Interval) and r.name == "probe"][-1]
        lags.append(probe.t0 - h0)
    assert max(abs(e) for e in errs) < 50e-6, errs
    assert min(lags) > -50e-6, lags
    gauges = [r for r in trace.records() if isinstance(r, trace.Gauge)]
    assert gauges and gauges[-1].sm_mhz > 0 and gauges[-1].power_w > 0


# -- the transformer family's other members: their shapes and paths -------


@pytest.mark.cuda
@pytest.mark.parametrize("act_bits", [16, 8])
@pytest.mark.parametrize("D,G", [(6144, 6), (7168, 7)],
                         ids=["internvl2", "deepseek"])
def test_flash_decode_fused_full_width_gqa_vs_plain(cuda, D, G, act_bits):
    """K6 and K7 at internvl2-26b's decode shape (D 6144, 48 heads of 128
    over 8) and deepseek-coder-33b's (D 7168, 56 over 8), B = 8, W = 640:
    clusters of 8 blocks, one per KV head (64 blocks); against their plain
    versions in bfloat16 and float32 (whose ring takes two stages at G =
    7), at a partial fill, a full cache and the eviction slot; K7 bitwise
    equal to K6 through a table of 16-slot pages."""
    nkv, dh, W, a8 = 8, 128, 640, act_bits == 8
    assert tfd.fused_plan(D, nkv, G, dh).cluster == 8
    x, ws = _fused_inputs(8, D, G, nkv, dh, act_bits, cuda, seed=G)
    ck, cv, kp, vp, table = _fused_slab_and_pages(x, W, nkv, dh, 16, cuda,
                                                  seed=D)
    for pos in (576, 640, 647):
        nv, ev = min(pos, W), (pos % W if pos >= W else -1)
        cos, sin = ops._rope_rows(pos, dh, 1e4, cuda)
        for dt in (torch.bfloat16, torch.float32):
            xd, ckd, cvd, kpd, vpd = (t.to(dt) for t in (x, ck, cv, kp, vp))
            got = tfd.flash_decode_fused_cuda(xd, *ws, ckd, cvd, nv, ev, cos,
                                              sin, True, a8)
            want = tfd.flash_decode_fused_plain(xd, *ws, ckd, cvd, nv, ev,
                                                cos, sin, True, a8)
            for g, w, tol in zip(got, want, _fused_tols(dt, a8, ws, cvd,
                                                        want)):
                torch.testing.assert_close(g, w, **tol)
            paged = tfd.flash_decode_fused_paged_cuda(
                xd, *ws, kpd, vpd, table, nv, ev, cos, sin, True, a8)
            for p, g in zip(paged, got):
                assert torch.equal(p, g)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 8, 4096])
@pytest.mark.parametrize("K,N", [(1024, 32), (6144, 8)],
                         ids=["granite_router", "mixtral_router"])
def test_router_shaped_matmuls_vs_plain(cuda, K, N, M, bits):
    """The MoE routers' narrow matmuls: granite's (1024, 32) on the bf16
    GEMV at decode and on ``qmm_tc`` at prefill (N = 32 passes the TMA's
    N % 16), mixtral's (6144, 8) on ``qmm_skinny`` / ``qmm_tiled``;
    against the plain version, each counted on the kernel ``route``
    names."""
    # weights at dense_init's scale (std 1/sqrt(K)), as a router's are, so
    # that outputs are O(1) as BF16_TOL's float32 summation term assumes
    rng = np.random.default_rng(M)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, N)) / np.sqrt(K))
                         .astype(np.float32))
    t = tptq.quantize(w, bits)
    x, q, s = x.to(cuda), t.q.to(cuda), t.scale.reshape(-1).to(cuda)
    xb = x.to(torch.bfloat16)
    name = "w8a16" if bits == 8 else "w4a16"
    ops.reset_launch_counts()
    got = tqm.quant_matmul_cuda(xb, q, s, bits)
    torch.testing.assert_close(got, tqm.quant_matmul_plain(xb, q, s, bits),
                               **BF16_TOL)
    counts = ops.launch_counts()
    wide = N % 16 == 0
    assert counts[name] == 1
    assert counts[name + "_gemv"] == int(M <= 8 and wide)
    assert counts[name + "_tc"] == int(M > 8 and wide)
    if bits == 8:
        xq, sx = tptq.quantize_rowwise(xb)
        ops.reset_launch_counts()
        got = tqm.quant_matmul_a8_cuda(xq, sx, q, s, torch.bfloat16)
        assert torch.equal(got, tqm.quant_matmul_a8_plain(xq, sx, q, s,
                                                          torch.bfloat16))
        counts = ops.launch_counts()
        assert counts["w8a8_gemv"] == int(M <= 8)
        assert counts["w8a8_tc"] == int(M > 8 and wide)


def _family_engine(arch, n_max=16, **cfg_kw):
    """A bfloat16 engine of ``arch`` cut to 2 layers and vocab 512 at its
    own widths (granite: 32 experts, top 8), B = 8."""
    from repro_torch.config import get_arch
    from repro_torch.serving.engine import ServingEngine
    cfg = get_arch(arch).scaled(n_layers=2, vocab=512, **cfg_kw)
    return ServingEngine(cfg, batch_capacity=8, s_max=32, n_max=n_max,
                         quant_bits=8, seed=5, device="cuda")


def _family_prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, size=n).tolist()
            for n in (5, 32, 9, 2, 17, 30, 1, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [0, 8, (8, 8), 4])
def test_captured_moe_step_equals_eager_and_replays_bitwise(cuda, bits):
    """granite's MoE layer (32 experts, top 8, static capacity, a stable
    sort for the top k, a fold for the combine) inside the captured decode
    step: ``generate`` (the device loop) equals ``generate_reference``
    (eager steps) bitwise, chunked equals it, and two replays of one
    captured step from the same state are bitwise equal."""
    eng = _family_engine("granite-moe-1b-a400m", d_model=512, n_heads=8,
                         n_kv_heads=4)
    assert eng.cfg.moe.n_experts == 32 and eng.cfg.moe.top_k == 8
    prompts, caps = _family_prompts(), [16, 3, 16, 9, 16, 1, 16, 12]
    ops.reset_launch_counts()
    a = eng.generate(prompts, caps, quant_bits=bits)
    b = eng.generate_reference(prompts, caps, quant_bits=bits)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    c = eng.generate_via_chunks(prompts, caps, k=5, quant_bits=bits)
    np.testing.assert_array_equal(c.tokens, a.tokens)
    runs = []
    for _ in range(2):
        st = eng.start_chunked(prompts, [16] * 8, quant_bits=bits)
        st = eng.generate_chunked(st, 8)
        out, lengths, _, t = eng.poll_chunked(st)
        runs.append((out, st.cur.clone(), [x["v"].clone() for x in st.cache]))
    (o1, c1, v1), (o2, c2, v2) = runs
    np.testing.assert_array_equal(o1, o2)
    assert torch.equal(c1, c2) and all(torch.equal(x, y)
                                       for x, y in zip(v1, v2))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [0, 8, (8, 8)])
def test_kv8_step_as_a_graph_equals_eager(cuda, bits):
    """qwen3 with the int8 KV cache: its decode step (quantize the token's
    k/v, write them and their scales, dequantize, the plain masked
    softmax; no decode-attention kernel) captured as a CUDA graph gives
    ``generate_reference``'s tokens bitwise, and so do the paged path over
    the arena's four leaves and the slab path with a refill."""
    from repro_torch.serving.kv_arena import KVArena
    eng = _family_engine("qwen3-1.7b", d_model=512, n_heads=4, n_kv_heads=2,
                         kv_bits=8)
    assert eng.decode_tier(bits) == "kv8"
    prompts, caps = _family_prompts(1), [16, 3, 16, 9, 16, 1, 16, 12]
    ops.reset_launch_counts()
    a = eng.generate(prompts, caps, quant_bits=bits)
    counts = ops.launch_counts()
    assert counts["decode_loop"] > 0
    assert not any(counts[k] for k in ("flash_decode", "flash_decode_paged",
                                       "flash_decode_fused",
                                       "flash_decode_fused_paged"))
    b = eng.generate_reference(prompts, caps, quant_bits=bits)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    arena = KVArena.for_engines(eng, block_tokens=16)
    assert len(arena.buffers()) == 4
    p = eng.generate_via_chunks(prompts, caps, k=5, quant_bits=bits,
                                arena=arena)
    np.testing.assert_array_equal(p.tokens, a.tokens)
    assert arena.free_pages == arena.total_pages


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, (8, 8), 4])
def test_vlm_engine_on_the_card(cuda, bits):
    """internvl2's VLM engine (256 zero patch embeddings ahead of the
    prompt, 2 layers at d_model 1536, 12 heads of 128 over 2: G = 6):
    ``generate == generate_reference`` and paged == slab == ``generate``,
    on the fused tier at W8A16 and W8A8 (K6, K7) and the unfused one at
    W4A16 (K4, K5)."""
    from repro_torch.serving.kv_arena import KVArena
    eng = _family_engine("internvl2-26b", d_model=1536, n_heads=12,
                         n_kv_heads=2)
    fused = bits in (8, (8, 8))
    assert eng.decode_tier(bits) == ("fused" if fused else "flash")
    prompts, caps = _family_prompts(2), [16, 3, 16, 9, 16, 1, 16, 12]
    ops.reset_launch_counts()
    a = eng.generate(prompts, caps, quant_bits=bits)
    assert ops.launch_counts()["flash_decode_fused" if fused
                               else "flash_decode"] > 0
    b = eng.generate_reference(prompts, caps, quant_bits=bits)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    arena = KVArena.for_engines(eng, block_tokens=16)
    ops.reset_launch_counts()
    p = eng.generate_via_chunks(prompts, caps, k=5, quant_bits=bits,
                                arena=arena)
    assert ops.launch_counts()["flash_decode_fused_paged" if fused
                               else "flash_decode_paged"] > 0
    np.testing.assert_array_equal(p.tokens, a.tokens)
    s = eng.generate_via_chunks(prompts, caps, k=5, quant_bits=bits)
    np.testing.assert_array_equal(s.tokens, a.tokens)


def _recurrent_engine(arch):
    """A bfloat16 engine of the recurrent, hybrid or audio family at its
    own widths, cut to every kind of block at 2-3 layers (xLSTM: 1 mLSTM +
    1 sLSTM; Zamba2: 2 Mamba2 layers + the shared block + 1; Whisper: 2
    decoder layers over 1500 frames) and vocab 512, B = 8."""
    import dataclasses
    from repro_torch.config import get_arch
    from repro_torch.serving.engine import ServingEngine
    cfg = get_arch(arch).scaled(vocab=512)
    if cfg.xlstm is not None:
        cfg = cfg.scaled(n_layers=2, xlstm=dataclasses.replace(
            cfg.xlstm, slstm_every=2))
    elif cfg.hybrid is not None:
        cfg = cfg.scaled(n_layers=3, hybrid=dataclasses.replace(
            cfg.hybrid, attn_every=2))
    else:
        cfg = cfg.scaled(n_layers=2)
    return ServingEngine(cfg, batch_capacity=8, s_max=32, n_max=16,
                         quant_bits=8, seed=5, device="cuda")


RECURRENT = ["xlstm-1.3b", "zamba2-7b", "whisper-tiny"]


def _no_kernel(counts):
    return counts["decode_loop"] > 0 and not any(
        v for k, v in counts.items() if k != "decode_loop")


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_captured_step_equals_eager_and_replays_bitwise(cuda, arch,
                                                                  bits):
    """The recurrent, hybrid and audio families' decode step captured in
    the device loop: the first ``generate`` after the capture equals
    ``generate_reference`` (eager steps) bitwise, with no kernel launched;
    a cohort advanced by the device loop equals the same cohort advanced
    by the eager loop, cache leaves included; two replays from the same
    state are bitwise equal."""
    eng = _recurrent_engine(arch)
    prompts, caps = _family_prompts(3), [16, 3, 16, 9, 16, 1, 16, 12]
    ops.reset_launch_counts()
    a = eng.generate(prompts, caps, quant_bits=bits)
    assert len(eng.captures) == 1 and _no_kernel(ops.launch_counts())
    b = eng.generate_reference(prompts, caps, quant_bits=bits)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    runs = []
    for eager in (False, False, True):
        st = eng.start_chunked(prompts, [16] * 8, quant_bits=bits)
        if eager:
            eng._advance = eng._advance_eager
        try:
            st = eng.generate_chunked(st, 8)
        finally:
            eng.__dict__.pop("_advance", None)
        out, _, _, t = eng.poll_chunked(st)
        assert t == 8
        runs.append((out, st.cur.clone(),
                     [x.clone() for layer in st.cache for x in layer.values()]))
    for o, c, leaves in runs[1:]:
        np.testing.assert_array_equal(o, runs[0][0])
        assert torch.equal(c, runs[0][1])
        assert all(torch.equal(x, y) for x, y in zip(leaves, runs[0][2]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mamba2_decode_kernel_vs_op_chain(cuda, dtype):
    """``kops.mamba2_decode`` (two kernels) against ``block_decode``'s op
    chain at Zamba2-7B-Instruct's widths (H 112 of P 64, N 64, two
    groups, conv 4 with bias), B = 8, random state and weights: the conv
    state equal bitwise, the SSM state within 1e-6 (the same float32
    operations in the same order), the layer's output within one unit of
    the model type's last place (the S C sum's order differs, which may
    round y one ulp apart) on the output's scale."""
    import dataclasses
    from repro_torch.config import get_arch
    from repro_torch.models import mamba2
    cfg = dataclasses.replace(get_arch("zamba2-7b-instruct"), dtype=dtype)
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(11)
    p = mamba2.init_block(cfg, gen, dt)
    H, C = 112, mamba2.conv_channels(cfg)
    rnd = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                     device="cuda")
    p.update(conv_b=(0.1 * rnd(C)).to(dt), D=rnd(H),
             dt_bias=rnd(H) - 3.0, A_log=torch.log(1 + 15 * rnd(H).abs()),
             gate_norm=(1 + 0.1 * rnd(7168)).to(dt))
    state = {"ssm": 0.5 * rnd(8, H, 64, 64),
             "conv": rnd(8, 3, C).to(dt)}
    u = rnd(8, 1, 3584).to(dt)
    s1 = {k: v.clone() for k, v in state.items()}
    s2 = {k: v.clone() for k, v in state.items()}
    ops.reset_launch_counts()
    want = mamba2.block_decode(cfg, p, u, s1, use_kernel=False)
    assert not any(ops.launch_counts().values())
    got = mamba2.block_decode(cfg, p, u, s2, use_kernel=True)
    assert ops.launch_counts()["mamba2_scan_step"] == 1
    assert torch.equal(s2["conv"], s1["conv"])
    torch.testing.assert_close(s2["ssm"], s1["ssm"], rtol=1e-6, atol=1e-6)
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -20
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 4 * ulp * scale


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [0, 8])
def test_published_zamba2_loop_equals_reference(cuda, bits):
    """The published Zamba2 block (two groups, a site over the
    concatenation, bf16) at its own widths cut to 3 Mamba2 layers with a
    site before layer 1: its step captured in the device loop equals
    ``generate_reference`` bitwise, and launches ``mamba2_decode`` once a
    layer and step, ``add_norm``, ``rope_qk_write`` and ``flash_decode``
    (K4, the site's attention) once a site and step, and no other kernel
    of the port."""
    import dataclasses
    from repro_torch.config import get_arch
    from repro_torch.serving import engine as eng_mod
    cfg = get_arch("zamba2-7b-instruct")
    cfg = cfg.scaled(n_layers=3, vocab=512, hybrid=dataclasses.replace(
        cfg.hybrid, sites=(1,)))
    eng = eng_mod.ServingEngine(cfg, batch_capacity=8, s_max=32, n_max=16,
                                quant_bits=8, seed=5, device="cuda")
    prompts, caps = _family_prompts(4), [16, 3, 16, 9, 16, 1, 16, 12]
    eng.generate(prompts, caps, quant_bits=bits)         # the capture
    ops.reset_launch_counts()
    a = eng.generate(prompts, caps, quant_bits=bits)
    counts = ops.launch_counts()
    assert counts["decode_loop"] == 1
    assert counts["mamba2_scan_step"] == counts["mamba2_gate_norm"] \
        == 3 * 16 and counts["add_norm"] > 0
    assert counts["rope_qk_write"] == counts["flash_decode"] == 16  # a site
    assert not any(v for k, v in counts.items() if k not in (
        "decode_loop", "mamba2_scan_step", "mamba2_gate_norm", "add_norm",
        "rope_qk_write", "flash_decode"))
    b = eng.generate_reference(prompts, caps, quant_bits=bits)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    assert eng.captures[-1]["ssm_state_bytes"] == 2 * sum(
        x.nbytes for layer in eng._gen.cache for k, x in layer.items()
        if k in ("ssm", "conv"))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_refilled_row_on_the_card(cuda, arch):
    """A row refilled at step 4 through the device loop equals the same
    prompt refilled at the same step into a cohort with no other live row,
    bitwise; an xLSTM row (no attention slots) also equals the prompt
    served alone."""
    eng = _recurrent_engine(arch)
    prompts = _family_prompts(4)
    new = [9, 8, 7, 6, 5]
    caps = [16] * 8
    caps[1] = 2
    rows = []
    for ps, cs in ((prompts, caps), ([prompts[0]], [4])):
        st = eng.start_chunked(ps, cs)
        st = eng.generate_chunked(st, 4)
        _, _, _, t = eng.poll_chunked(st)
        assert t == 4
        st = eng.refill_chunked(st, [1], [new], [10], t_now=t)
        while True:
            st = eng.generate_chunked(st, 4)
            out, lengths, done, t = eng.poll_chunked(st)
            if eng.exhausted(lengths, done, st.caps_host, t):
                break
        rows.append(out[1, :lengths[1]])
    np.testing.assert_array_equal(rows[0], rows[1])
    assert len(rows[0]) >= 1
    if arch == "xlstm-1.3b":
        solo = eng.generate([new], [10])
        np.testing.assert_array_equal(rows[0],
                                      solo.tokens[0, :solo.lengths[0]])


@pytest.mark.cuda
@pytest.mark.parametrize("arch,paged", [
    ("bloom-3b", False), ("bloom-3b", True), ("granite-moe-1b-a400m", False),
    ("internvl2-26b", False)] + [(a, False) for a in RECURRENT])
def test_capture_leaves_every_cache_leaf_unchanged(cuda, arch, paged):
    """Capturing a freshly prefilled cohort's step (its warm-up step runs
    with the loop dead, on a side stream) leaves every cache leaf, slab or
    arena, and every emission tensor bitwise as it found them, in all six
    families; the captured loop then runs from that state."""
    from repro_torch.serving.kv_arena import KVArena
    eng = _recurrent_engine(arch) if arch in RECURRENT \
        else _family_engine(arch)
    arena = KVArena.for_engines(eng, block_tokens=16) if paged else None
    st = eng.start_chunked(_family_prompts(5), [16] * 8, arena=arena)

    def snapshot():
        leaves = st.arena.buffers().values() if paged else \
            [t for layer in st.cache for t in layer.values()]
        return [t.clone() for t in leaves] + [getattr(st, n).clone() for n in (
            "cur", "out", "lengths", "done", "t_dev", "t_end")]

    before = snapshot()
    eng._capture(st)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(before, snapshot()))
    if paged:
        eng.release_all(st)


# ---------------------------------------------------------------------------
# Training (M10): float weights, so no kernel launches
# ---------------------------------------------------------------------------

# one reduced model of each family at float32; xLSTM and Zamba2 with every
# kind of block at 5 layers
TRAIN_CASES = {"olmo-1b": {}, "granite-moe-1b-a400m": {},
               "internvl2-26b": {},
               "xlstm-1.3b": dict(n_layers=5, xlstm=dict(slstm_every=2)),
               "zamba2-7b": dict(n_layers=5, hybrid=dict(attn_every=2)),
               "whisper-tiny": {}}
# card against CPU, relative: the loss every step, grad_norm and lr at the
# first (the same weights: float32 sums in other orders) within TRAIN_TOL;
# grad_norm and lr after the first AdamW update within TRAIN_TOL_LATER
# (Adam's normalised step turns a gradient element near zero into an
# update of full size, so the devices' weights part: reduced Zamba2's
# grad_norm read 1.07e-4 apart at step 2 on an H100)
TRAIN_TOL, TRAIN_TOL_LATER = 1e-4, 1e-3


def _train_cfg(arch):
    import dataclasses
    from repro_torch.config import get_arch
    from repro_torch.launch.serve import reduced
    cfg = reduced(get_arch(arch))
    kw = {k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
          else v for k, v in TRAIN_CASES[arch].items()}
    return cfg.scaled(dtype="float32", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(TRAIN_CASES))
def test_train_steps_on_the_card_match_the_cpu(cuda, arch):
    """Three train steps from the same weights and batches on the card and
    on the CPU, within ``TRAIN_TOL`` / ``TRAIN_TOL_LATER``; no kernel
    counter moves."""
    from repro_torch import bridge
    from repro_torch.train import Trainer, TrainState
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    cfg = _train_cfg(arch)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    cpu = Trainer(cfg, batch=2, seq=32, opt_cfg=opt, device="cpu")
    gpu = Trainer(cfg, batch=2, seq=32, opt_cfg=opt, device="cuda")
    s_cpu = cpu.init_state()
    params = bridge.to_device(s_cpu.params, "cuda")
    ops.reset_launch_counts()
    _, hg = gpu.run(3, state=TrainState(params, adamw_init(params)),
                    log_every=1, log=lambda s: None)
    assert not any(ops.launch_counts().values())
    _, hc = cpu.run(3, state=s_cpu, log_every=1, log=lambda s: None)
    for i, (a, b) in enumerate(zip(hg, hc)):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=TRAIN_TOL)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(
                a[k], b[k], rtol=TRAIN_TOL if i == 0 else TRAIN_TOL_LATER)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(TRAIN_CASES))
def test_remat_on_equals_off_on_the_card(cuda, arch):
    """The loss and every gradient leaf with the remat policy on and off,
    on the card: the loss bitwise, each leaf within 1e-6 of its largest
    magnitude (a backward may accumulate in another order)."""
    from repro_torch.models.api import build_model
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.trainer import to_batch, value_and_grad
    from repro_torch.utils.remat import remat_scan
    from repro_torch.utils.tree import tree_leaves
    cfg = _train_cfg(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = to_batch(SyntheticLM(cfg, 2, 32).next_batch(), "cuda")
    (l0, _), g0 = value_and_grad(model.loss_fn, params, batch)
    with remat_scan(True):
        (l1, _), g1 = value_and_grad(model.loss_fn, params, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max())


@pytest.mark.cuda
def test_train_launcher_one_step_on_the_card(cuda, tmp_path):
    """``launch.train.main`` at the reduced shape on the card: one step,
    a checkpoint that restores onto the card, no kernel launched."""
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.api import build_model
    from repro_torch.config import get_arch
    from repro_torch.train import checkpoint
    from repro_torch.train.optimizer import adamw_init
    path = str(tmp_path / "ck.npz")
    ops.reset_launch_counts()
    assert tlaunch.main(["--reduced", "--steps", "1", "--batch", "2",
                         "--seq", "16", "--checkpoint", path]) == 0
    assert not any(ops.launch_counts().values())
    cfg = get_arch("olmo-1b").scaled(**dict(tlaunch.REDUCED, n_kv_heads=4))
    params = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    _, opt = checkpoint.restore(path, (params, adamw_init(params)))
    assert int(opt.step) == 1 and opt.mu["embed"].is_cuda


# ---------------------------------------------------------------------------
# No card needed: the wrappers refuse what the kernels do not take
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_wrapper_refuses_cpu_tensors(bits):
    x, q, s = _mm_inputs(2, 16, 8, bits, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tqm.quant_matmul_cuda(x, q, s, bits)
    xq, sx = tptq.quantize_rowwise(x)
    if bits == 8:
        with pytest.raises(ValueError, match="CUDA"):
            tqm.quant_matmul_a8_cuda(xq, sx, q, s, torch.float32)


def test_quant_matmul_wrapper_refuses_wrong_types():
    x, q, s = _mm_inputs(2, 16, 8, 8, "cpu")
    with pytest.raises(TypeError):
        tqm.quant_matmul_cuda(x.to(torch.float16), q, s, 8)
    with pytest.raises(ValueError):
        tqm.quant_matmul_cuda(x, q, s, 3)
    with pytest.raises(TypeError):
        tqm.quant_matmul_a8_cuda(*tptq.quantize_rowwise(x), q, s,
                                 torch.float16)


def test_flash_decode_wrapper_refuses_cpu_tensors():
    q, k, v, nv = _decode_inputs(2, 4, 2, 80, 16, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tfd.flash_decode_cuda(q, k, v, nv)
    with pytest.raises(TypeError):
        tfd.flash_decode_cuda(q.to(torch.float16), k, v, nv)


def test_flash_decode_paged_wrapper_refuses_cpu_tensors():
    q, kp, vp, table, nv = _paged_inputs(2, 4, 2, 80, 3, 8, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tfd.flash_decode_paged_cuda(q, kp, vp, table, nv)
    with pytest.raises(TypeError):
        tfd.flash_decode_paged_cuda(q.to(torch.float16), kp, vp, table, nv)


def test_ops_refuse_other_devices():
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.quant_matmul(x, torch.zeros((4, 4), dtype=torch.int8),
                         torch.ones(4))
    q = torch.zeros((2, 4, 8), device="meta")
    pages = torch.zeros((5, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_decode_paged(q, pages, pages,
                               torch.zeros((2, 3), dtype=torch.int32), 5)


@pytest.mark.parametrize("a8", [False, True])
def test_flash_decode_fused_wrappers_refuse_cpu_tensors(a8):
    x, ws = _fused_inputs(2, 64, 1, 2, 32, 8 if a8 else 16, "cpu")
    ck, cv, kp, vp, table = _fused_slab_and_pages(x, 16, 2, 32, 8, "cpu")
    cos, sin = ops._rope_rows(3, 32, 1e4, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tfd.flash_decode_fused_cuda(x, *ws, ck, cv, 3, -1, cos, sin, True, a8)
    with pytest.raises(ValueError, match="CUDA"):
        tfd.flash_decode_fused_paged_cuda(x, *ws, kp, vp, table, 3, -1, cos,
                                          sin, True, a8)
    with pytest.raises(TypeError):
        tfd.flash_decode_fused_cuda(x.to(torch.float16), *ws, ck, cv, 3, -1,
                                    cos, sin, True, a8)
