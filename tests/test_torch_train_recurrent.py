"""The port's gradients against ``jax.grad`` of the reference's
``loss_fn`` for the recurrent, hybrid and audio families (xLSTM, Zamba2,
Whisper), and at ties of the stabilizers' maxima, where JAX gives each
side half the gradient.  Setup and tolerances as in
``tests/test_torch_train_families.py``; the tie tests hold each gradient
at rtol 1e-5 (atol 1e-5 for mLSTM, 1e-6 for the sLSTM cell)."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch.models import xlstm as txlstm  # noqa: E402
from test_torch_train_families import _check_gradients  # noqa: E402


@pytest.mark.parametrize("case", ["xlstm-1.3b-mixed", "zamba2-7b-mixed",
                                  "whisper-tiny"])
def test_gradients_match_jax_grad(case):
    """Every kind of block: mLSTM, sLSTM, Mamba2 with the shared attention
    and a tail, Whisper's encoder, cross-attention and decoder."""
    _check_gradients(case)


def test_mlstm_stabilizer_ties_gradients_match():
    """``mlstm_chunked`` at ties of every max it takes: zero gates and a
    zero start stabilizer make m_intra == m_inter and m + F == the state
    stabilizer's max in both chunks, and every row of the decay matrix
    ties in its max; one query row is zero (|den| = 0).  The gradients of
    h and of the end state (C, n, m), against ``jax.grad``."""
    rng = np.random.default_rng(4)
    Bq, T, nh, dh, Q = 2, 8, 2, 4, 4
    q, k, v = (rng.standard_normal((Bq, T, nh, dh)).astype(np.float32)
               for _ in range(3))
    q[0, 3] = 0.0
    ilog = np.zeros((Bq, T, nh), np.float32)
    flog = np.zeros((Bq, T, nh), np.float32)
    C0 = rng.standard_normal((Bq, nh, dh, dh)).astype(np.float32)
    n0 = rng.standard_normal((Bq, nh, dh)).astype(np.float32)
    m0 = np.zeros((Bq, nh), np.float32)
    wh = rng.standard_normal((Bq, T, nh, dh)).astype(np.float32)
    wC = rng.standard_normal((Bq, nh, dh, dh)).astype(np.float32)
    wn = rng.standard_normal((Bq, nh, dh)).astype(np.float32)
    args = (q, k, v, ilog, flog, C0, n0, m0)

    def jloss(q, k, v, i, f, C, n, m):
        h, st = jxlstm.mlstm_chunked(q, k, v, i, f, Q,
                                     {"C": C, "n": n, "m": m})
        return (jnp.sum(h * wh) + jnp.sum(st["C"] * wC)
                + jnp.sum(st["n"] * wn) + jnp.sum(st["m"]))

    want = jax.grad(jloss, argnums=tuple(range(8)))(
        *(jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    h, st = txlstm.mlstm_chunked(*ts[:5], Q, {"C": ts[5], "n": ts[6],
                                              "m": ts[7]})
    assert torch.all(st["m"] == 0)           # the tie held to the end
    loss = (torch.sum(h * torch.from_numpy(wh))
            + torch.sum(st["C"] * torch.from_numpy(wC))
            + torch.sum(st["n"] * torch.from_numpy(wn)) + torch.sum(st["m"]))
    got = torch.autograd.grad(loss, ts)
    for name, g, w in zip("q k v ilog flog C n m".split(), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_slstm_cell_ties_gradients_match():
    """One sLSTM step at n == 1e-6, where ``max(n, 1e-6)`` ties (the
    forget gate's value is the same over each head's dims, so its max ties
    too and fs is exactly 1; the input gate at -1e4 makes is_ exactly 0):
    at a tie the JAX package's ``jnp.maximum`` gives each side half the
    gradient, which ``torch.clamp`` would not.  Gradients of the new state
    against ``jax.grad``."""
    rng = np.random.default_rng(5)
    Bq, nh, dh = 2, 2, 4
    dm = nh * dh
    gates = rng.standard_normal((Bq, 4, nh, dh)).astype(np.float32)
    gates[:, 1] = -1e4                                    # input gate
    gates[:, 2] = rng.standard_normal((Bq, nh, 1))        # forget gate
    xw = gates.reshape(Bq, 4 * dm)
    r = np.zeros((4, nh, dh, dh), np.float32)
    b = np.zeros((4 * dm,), np.float32)
    c0 = rng.standard_normal((Bq, nh, dh)).astype(np.float32)
    n0 = np.full((Bq, nh, dh), 1e-6, np.float32)
    h0 = rng.standard_normal((Bq, nh, dh)).astype(np.float32)
    m0 = np.zeros((Bq, nh), np.float32)
    w = [rng.standard_normal(a.shape).astype(np.float32)
         for a in (c0, n0, h0, m0)]
    args = (xw, r, b, c0, n0, h0, m0)

    def jloss(xw, r, b, c, n, h, m):
        out = jxlstm._slstm_cell_step({"r_gates": r, "b_gates": b}, nh, dh,
                                      xw, (c, n, h, m))
        return sum(jnp.sum(o * wi) for o, wi in zip(out, w))

    want = jax.grad(jloss, argnums=tuple(range(7)))(
        *(jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    out = txlstm._slstm_cell_step({"r_gates": ts[1], "b_gates": ts[2]}, nh,
                                  dh, ts[0], tuple(ts[3:]))
    assert torch.all(out[1] == n0[0, 0, 0])     # n stayed at 1e-6: a tie
    loss = sum(torch.sum(o * torch.from_numpy(wi)) for o, wi in zip(out, w))
    got = torch.autograd.grad(loss, ts)
    for name, g, wt in zip("xw r b c n h m".split(), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
