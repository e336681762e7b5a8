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
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

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
def test_ops_route_cuda_tensors_to_the_kernels(cuda):
    x, q, s = _mm_inputs(4, 128, 64, 8, cuda)
    w = tptq.QTensor(q, s.reshape(1, -1), 8, (128, 64), torch.float32, 8)
    ops.reset_launch_counts()
    ops.qmatmul(x.reshape(2, 2, 128), w)
    qd, kd, vd, nv = _decode_inputs(2, 4, 4, 80, 16, cuda)
    ops.flash_decode(qd, kd, vd, nv)
    counts = ops.launch_counts()
    assert counts["w8a8"] == 1 and counts["flash_decode"] == 1
    assert counts["w8a16"] == counts["w4a16"] == 0


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


def test_ops_refuse_other_devices():
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.quant_matmul(x, torch.zeros((4, 4), dtype=torch.int8),
                         torch.ones(4))
