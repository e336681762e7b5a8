"""The port's PTQ against the JAX package's: integers and scales bitwise."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.quant import ptq as jptq  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.quant import ptq as tptq  # noqa: E402


def _weights(shape, seed):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[..., 0, 0] = 0.0
    w[..., :, -1] = 0.0         # an all-zero column: scale 1.0
    return w


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(8, 6), (7, 5), (64, 33), (3, 9, 4)])
def test_quantize_bitwise(shape, bits):
    w = _weights(shape, 0)
    a = jptq.quantize(jnp.asarray(w), bits)
    b = tptq.quantize(torch.from_numpy(w), bits)
    np.testing.assert_array_equal(np.asarray(a.q), b.q.numpy())
    np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy())
    np.testing.assert_array_equal(np.asarray(jptq.dequantize(a)),
                                  tptq.dequantize(b).numpy())
    assert a.nbytes == b.nbytes


def test_int4_pack_unpack_every_byte():
    allb = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    np.testing.assert_array_equal(
        np.asarray(jptq.unpack_int4(jnp.asarray(allb))),
        tptq.unpack_int4(torch.from_numpy(allb)).numpy())
    v = np.random.default_rng(1).integers(-8, 8, size=(6, 5)).astype(np.int8)
    np.testing.assert_array_equal(
        np.asarray(jptq.pack_int4(jnp.asarray(v))),
        tptq.pack_int4(torch.from_numpy(v)).numpy())


@pytest.mark.parametrize("shape", [(4, 80), (3, 257), (2, 5, 16)])
def test_quantize_rowwise_bitwise(shape):
    x = (np.random.default_rng(2).standard_normal(shape) * 3).astype(
        np.float32)
    x[0] = 0.0                  # an all-zero row: scale 1.0
    qa, sa = jptq.quantize_rowwise(jnp.asarray(x))
    qb, sb = tptq.quantize_rowwise(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(qa), qb.numpy())
    np.testing.assert_array_equal(np.asarray(sa), sb.numpy())


@pytest.mark.parametrize("bits,act_bits", [(8, 16), (4, 16), (8, 8)])
def test_quantize_bridged_tree_bitwise(bits, act_bits):
    """The port quantizes the bridged float tree itself; per layer it gives
    the JAX package's layer-stacked integers bit for bit."""
    cfg = reduced_cfg("bloom-3b").scaled(dtype="float32")
    p = jtr.init_params(cfg, jax.random.key(0))
    jq = jptq.quantize_tree(p, bits, act_bits=act_bits)
    tq = tptq.quantize_tree(bridge.from_jax_params(jax.device_get(p),
                                                   cfg.n_layers, "cpu"),
                            bits, act_bits=act_bits)
    np.testing.assert_array_equal(np.asarray(jq["embed"].q), tq["embed"].q.numpy())
    for i, layer in enumerate(tq["layers"]):
        for grp, key in [("attn", "wq"), ("attn", "wo"), ("ffn", "w1"),
                         ("ffn", "w2")]:
            a, b = jq["layers"][grp][key], layer[grp][key]
            assert isinstance(b, tptq.QTensor) and b.act_bits == act_bits
            np.testing.assert_array_equal(np.asarray(a.q)[i], b.q.numpy())
            np.testing.assert_array_equal(np.asarray(a.scale)[i],
                                          b.scale.numpy())
        assert not isinstance(layer["norm1"], tptq.QTensor)
    assert jptq.tree_bytes(jq) == tptq.tree_bytes(tq)

