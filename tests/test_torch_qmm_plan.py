"""The W8A16 / W4A16 wrapper's plan and the identity its tensor-core kernel
rests on, on the CPU.

``quant_matmul.route`` decides from shapes and types alone which kernel a
CUDA call launches: the skinny decode kernel at M <= 8, the tensor-core
kernel for bfloat16 x at M > 8 where the TMA can read the operands, the
CUDA-core tiled kernel otherwise.  The tensor-core kernel takes the
per-column scale out of the sum, bf16(s * (x @ q)); that differs from the
plain version, bf16(x @ (q * s)), only in where s is rounded and in the
order of the sum, so it is held to the card tests' bf16 tolerance: one
bf16 ulp of the output (rtol 2^-7) plus the float32 summation error
(atol 1e-4).
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quant_matmul as tqm  # noqa: E402
from repro_torch.quant import ptq as tptq  # noqa: E402

BF16 = torch.bfloat16
BF16_TOL = dict(rtol=2 ** -7, atol=1e-4)


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
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("phase", sorted(SERVING_M))
def test_serving_shapes_take_the_tensor_cores_at_prefill(arch, bits, phase):
    M = SERVING_M[phase]
    for K, N in _layer_shapes(arch):
        want = "skinny" if phase == "decode" else "tc"
        assert tqm.route(M, K, N, BF16, bits) == want, (arch, K, N)
        # a float32 model (the reduced reference models) stays on CUDA cores
        assert tqm.route(M, K, N, torch.float32, bits) == \
            ("skinny" if phase == "decode" else "tiled")


@pytest.mark.parametrize("case", [
    # (M, K, N, dtype, bits, aligned, route)
    (1, 2560, 2560, BF16, 8, True, "skinny"),
    (8, 80, 272, BF16, 4, True, "skinny"),
    (8, 81, 200, torch.float32, 8, False, "skinny"),
    (9, 64, 16, BF16, 8, True, "tc"),
    (16, 64, 272, BF16, 4, True, "tc"),
    (129, 80, 272, BF16, 8, True, "tc"),
    (129, 72, 2560, BF16, 4, True, "tc"),       # 36 packed rows: ragged
    (520, 10240, 10240, BF16, 8, True, "tc"),
    (129, 81, 272, BF16, 4, True, "tiled"),     # odd K: x's rows not 16 B
    (129, 84, 272, BF16, 8, True, "tiled"),     # K % 8 != 0
    (129, 80, 200, BF16, 8, True, "tiled"),     # N % 16 != 0
    (129, 80, 40, BF16, 4, True, "tiled"),
    (129, 80, 272, BF16, 8, False, "tiled"),    # an unaligned base pointer
    (4096, 2560, 2560, torch.float32, 8, True, "tiled"),
    (4096, 2560, 2560, torch.float32, 4, True, "tiled"),
])
def test_route(case):
    M, K, N, dtype, bits, aligned, want = case
    assert tqm.route(M, K, N, dtype, bits, aligned) == want


def _inputs(M, K, N, bits, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    t = tptq.quantize(torch.from_numpy(w), bits)
    xb = torch.from_numpy(x).to(BF16)
    return xb, t.q, t.scale.reshape(-1)


def _scale_after_sum(xb, q, s, bits):
    """What the tensor-core kernel computes: exact int weights in the sum,
    one float32 multiply by s[n] after it, one rounding to bf16."""
    qf = (tptq.unpack_int4(q)[:xb.shape[1]] if bits == 4 else q).float()
    return ((xb.float() @ qf) * s.float()).to(BF16)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kn", _layer_shapes("bloom-3b"))
def test_scale_after_sum_within_bf16_tolerance(kn, bits):
    K, N = kn
    xb, q, s = _inputs(64, K, N, bits, seed=K + N + bits)
    got = _scale_after_sum(xb, q, s, bits)
    torch.testing.assert_close(got, tqm.quant_matmul_plain(xb, q, s, bits),
                               **BF16_TOL)
    # and against the JAX package's reference, in float32 on the same
    # bf16 values of x: one rounding to bf16 apart
    want = np.asarray(ref.quant_matmul_ref(
        jnp.asarray(xb.float().numpy()), jnp.asarray(q.numpy()),
        jnp.asarray(s.numpy()), bits))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-4)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper's plan is never consulted: no kernel launches
    and no tensor-core count."""
    xb, q, s = _inputs(129, 80, 272, 8, seed=0)
    ops.reset_launch_counts()
    got = ops.quant_matmul(xb, q, s, 8)
    assert not any(ops.launch_counts().values())
    assert set(ops.launch_counts()) >= {"w8a16_tc", "w4a16_tc"}
    torch.testing.assert_close(got, tqm.quant_matmul_plain(xb, q, s, 8),
                               rtol=0, atol=0)
