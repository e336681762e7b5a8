"""The port's kernels: plain versions against ``repro.kernels.ref`` on the
CPU, the dispatch in ``kernels.ops``.  The CUDA kernels against their plain
versions are in ``test_torch_cuda.py``."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.quant import ptq as jptq  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quant_matmul as tqm  # noqa: E402
from repro_torch.quant import ptq as tptq  # noqa: E402

MKN = [(3, 80, 200), (8, 256, 96), (1, 64, 33), (17, 128, 40)]


def _mm_inputs(M, K, N, bits, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    t = tptq.quantize(torch.from_numpy(w), bits)
    return x, t.q.numpy(), t.scale.reshape(-1).numpy()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mkn", MKN)
def test_quant_matmul_plain_vs_ref(mkn, bits):
    x, q, s = _mm_inputs(*mkn, bits)
    want = np.asarray(ref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(q),
                                           jnp.asarray(s), bits))
    got = tqm.quant_matmul_plain(torch.from_numpy(x), torch.from_numpy(q),
                                 torch.from_numpy(s), bits).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mkn", MKN)
def test_quant_matmul_a8_plain_bitwise(mkn):
    x, q, s = _mm_inputs(*mkn, 8, seed=1)
    xq, sx = jptq.quantize_rowwise(jnp.asarray(x))
    want_acc = np.asarray(xq, np.int64) @ np.asarray(q, np.int64)
    txq, tsx = tptq.quantize_rowwise(torch.from_numpy(x))
    acc = tqm.a8_accumulate_plain(txq, torch.from_numpy(q))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    want = np.asarray(ref.quant_matmul_a8_ref(jnp.asarray(x), jnp.asarray(q),
                                              jnp.asarray(s)))
    got = tqm.quant_matmul_a8_plain(txq, tsx, torch.from_numpy(q),
                                    torch.from_numpy(s), torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def _decode_inputs(B, nh, nkv, dh, W, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, nh, dh)).astype(np.float32)
    k = rng.standard_normal((B, W, nkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, W, nkv, dh)).astype(np.float32)
    nv = rng.integers(1, W + 1, size=(B,)).astype(np.int32)
    return q, k, v, nv


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("dh", [64, 80])
def test_flash_decode_plain_vs_ref(G, dh):
    q, k, v, nv = _decode_inputs(3, 2 * G, 2, dh, 40)
    want = np.asarray(ref.flash_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(nv)))
    args = [torch.from_numpy(a) for a in (q, k, v)]
    got = tfd.flash_decode_plain(*args, torch.from_numpy(nv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # a scalar count masks every row alike
    want1 = np.asarray(ref.flash_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), 7))
    got1 = ops.flash_decode(*args, 7).numpy()
    np.testing.assert_allclose(got1, want1, rtol=1e-5, atol=1e-5)


def _paged_inputs(B, nh, nkv, dh, n_b, bt, seed=0):
    """A scrambled page arena with garbage outside the table's pages."""
    rng = np.random.default_rng(seed)
    P = 2 + B * n_b + 3
    q = rng.standard_normal((B, nh, dh)).astype(np.float32)
    kp = rng.standard_normal((P, bt, nkv, dh)).astype(np.float32)
    vp = rng.standard_normal((P, bt, nkv, dh)).astype(np.float32)
    table = (2 + rng.permutation(P - 2)[:B * n_b]).reshape(B, n_b)
    return q, kp, vp, table.astype(np.int32)


@pytest.mark.parametrize("G,dh,bt", [(1, 80, 8), (1, 80, 16), (2, 64, 4)])
def test_flash_decode_paged_plain_vs_jax_gather_path(G, dh, bt):
    """The plain paged version equals the JAX package's gather path
    (``pages[table]`` into a slab, masked ``gqa_attention``) and, bitwise,
    ``flash_decode_plain`` on the gathered slab, with n_valid on, one
    under and one over page edges."""
    from repro.models.common import gqa_attention
    B, n_b = 6, 5
    q, kp, vp, table = _paged_inputs(B, 2 * G, 2, dh, n_b, bt)
    W = n_b * bt
    nv = np.array([1, bt - 1, bt, bt + 1, W - 1, W], np.int32)
    kd, vd = (jnp.asarray(p)[jnp.asarray(table)].reshape(B, W, 2, dh)
              for p in (kp, vp))
    mask = (jnp.arange(W)[None, :] < jnp.asarray(nv)[:, None])
    want = np.asarray(gqa_attention(jnp.asarray(q)[:, None], kd, vd,
                                    mask[:, None, None, None, :]))[:, 0]
    t = [torch.from_numpy(a) for a in (q, kp, vp, table, nv)]
    got = tfd.flash_decode_paged_plain(*t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    slab = [torch.from_numpy(np.array(a)) for a in (kd, vd)]
    assert torch.equal(got, tfd.flash_decode_plain(t[0], *slab, t[4]))
    assert torch.equal(ops.flash_decode_paged(*t[:4], 7),
                       tfd.flash_decode_plain(t[0], *slab, 7))


def test_flash_decode_paged_plain_reads_a_corner_view():
    q, kp, vp, table = _paged_inputs(3, 2, 2, 80, 4, 8, seed=1)
    wide = [np.zeros(p.shape[:2] + (4, 128), np.float32) for p in (kp, vp)]
    for w, p in zip(wide, (kp, vp)):
        w[..., :2, :80] = p
    t = [torch.from_numpy(a) for a in (q, table)]
    corner = [torch.from_numpy(w)[..., :2, :80] for w in wide]
    got = tfd.flash_decode_paged_plain(t[0], *corner, t[1], 20)
    want = tfd.flash_decode_paged_plain(t[0], torch.from_numpy(kp),
                                        torch.from_numpy(vp), t[1], 20)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits,act_bits,tier", [(8, 16, "w8a16"),
                                                (4, 16, "w4a16"),
                                                (8, 8, "w8a8")])
def test_ops_cpu_tensors_take_the_plain_version(bits, act_bits, tier):
    """On the CPU the entry point computes the plain version and launches
    nothing; leading axes are flattened and restored."""
    x, q, s = _mm_inputs(6, 80, 24, bits, seed=2)
    ops.reset_launch_counts()
    w = tptq.QTensor(torch.from_numpy(q), torch.from_numpy(s).reshape(1, -1),
                     bits, (80, 24), torch.float32, act_bits)
    got = ops.qmatmul(torch.from_numpy(x).reshape(2, 3, 80), w)
    assert got.shape == (2, 3, 24)
    if act_bits == 8:
        xq, sx = tptq.quantize_rowwise(torch.from_numpy(x))
        want = tqm.quant_matmul_a8_plain(xq, sx, w.q, w.scale.reshape(-1),
                                         torch.float32)
    else:
        want = tqm.quant_matmul_plain(torch.from_numpy(x), w.q,
                                      w.scale.reshape(-1), bits)
    np.testing.assert_array_equal(got.reshape(6, 24).numpy(), want.numpy())
    assert ops.launch_counts()[tier] == 0
    assert not any(ops.launch_counts().values())


def test_decode_tier_and_fused_gate():
    cfg = get_arch("bloom-3b")
    assert not ops.fusable_decode({}, cfg)
    assert ops.decode_kernel_tier({}, cfg) == "flash"
    # the int8 KV cache takes the plain dequantize-and-attend path, as in
    # the JAX package
    assert ops.decode_kernel_tier({}, cfg.scaled(kv_bits=8)) == "kv8"


def test_split_plan_covers_k():
    for M, N, K in [(8, 2560, 2560), (8, 2560, 10240), (8, 10240, 2560),
                    (3, 200, 80), (64, 2560, 2560)]:
        splits, kps = tqm._splits(M, N, K)
        assert kps % 256 == 0 or splits == 1
        assert (splits - 1) * kps < K <= splits * kps
