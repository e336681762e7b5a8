"""The split-KV design of K4/K5 (``csrc/flash_decode.cu``), checked on the
CPU where the kernel cannot run.

A row's slots are cut into splits of ``SPLIT`` logical slots
(``flash_decode.split_plan``); one block per (split, kv head, row) writes
float32 partials (m, l, acc), and a merge sums the splits below n_valid in
index order.  ``_mirror`` below is that split-then-merge algorithm in numpy
float32, with the kernel's partition of each sum: 4 lanes of a slot over
8-element chunks of d_head and an xor tree for the scores, lanes over slots
and a 32-lane xor tree for the softmax denominator, interleaved slot groups
summed in index order for P.V, then the merge.  It rounds each product
before adding it where the kernel fuses the two (``fmaf``), so it checks
the algorithm at float32 tolerance, not the kernel's bits.  It is held
against the JAX package's oracle ``repro.kernels.ref.flash_decode_ref``
(not ``repro.kernels.ops``, whose Pallas path fails on this JAX version).
The kernel's own bits (K5 == K4, rows invariant in B and W) are held by the
card tests in ``tests/test_torch_cuda.py``.
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
from repro_torch.kernels import flash_decode as tfd  # noqa: E402

F32 = np.float32
CH = 8            # d_head elements of one chunk
LG = 4            # lanes of one slot in the score phase
THREADS = 128     # threads of one split block (csrc/flash_decode.cu)
TOL = dict(rtol=1e-5, atol=1e-5)


def _xor_tree(x, widths):
    """Sum over the last axis as the kernel's xor shuffles do: each step
    adds the lane ``i ^ w``; every lane ends with the same value."""
    idx = np.arange(x.shape[-1])
    for w in widths:
        x = (x + x[..., idx ^ w]).astype(F32)
    return x[..., 0]


def _split_partial(qs, kt, vt, n):
    """(m, l, acc) of one split: qs (G, DP) scaled, kt/vt (n, DP)."""
    G, DP = qs.shape
    C = DP // CH
    prod = (qs[:, None, :] * kt[None]).astype(F32).reshape(G, n, C, CH)
    lanes = np.zeros((G, n, LG), F32)
    for c in range(C):                      # lane c % LG walks its chunks
        for e in range(CH):
            lanes[..., c % LG] += prod[..., c, e]
    s = _xor_tree(lanes, [LG >> i for i in range(1, LG.bit_length())])
    m = s.max(-1)
    p = np.exp(s - m[:, None]).astype(F32)
    lane_sum = np.zeros((G, 32), F32)
    for j in range(n):                      # lane j % 32, in slot order
        lane_sum[:, j % 32] += p[:, j]
    l = _xor_tree(lane_sum, (16, 8, 4, 2, 1))
    ng = 1 if G * C >= THREADS else THREADS // (G * C)
    groups = np.zeros((ng, G, DP), F32)
    for j in range(n):                      # slot group j % ng, in order
        groups[j % ng] += (p[:, j, None] * vt[None, j]).astype(F32)
    acc = groups[0].copy()
    for kg in range(1, ng):
        acc += groups[kg]
    return m, l, acc


def _mirror(q, k, v, n_valid):
    """K4's function in the kernel's order: q (B, nh, dh), k/v
    (B, W, nkv, dh) float32, n_valid (B,)."""
    B, nh, dh = q.shape
    W, nkv = k.shape[1], k.shape[2]
    G = nh // nkv
    DP = math.ceil(dh / CH) * CH
    scale = F32(1.0 / dh ** 0.5)
    pad = [(0, 0), (0, DP - dh)]
    out = np.zeros((B, nh, dh), F32)
    for b in range(B):
        nv = min(int(n_valid[b]), W)
        for h in range(nkv):
            qs = np.pad(q[b, h * G:(h + 1) * G] * scale, pad)
            parts = []
            for s0, _ in tfd.split_plan(W):
                if s0 >= nv:
                    break
                n = min(tfd.SPLIT, nv - s0)
                parts.append(_split_partial(
                    qs, np.pad(k[b, s0:s0 + n, h], pad),
                    np.pad(v[b, s0:s0 + n, h], pad), n))
            mx = np.max(np.stack([p[0] for p in parts]), 0)
            l = np.zeros(G, F32)
            acc = np.zeros((G, DP), F32)
            for m, ls, a in parts:          # the merge, in split order
                w = np.exp(m - mx).astype(F32)
                l = (l + w * ls).astype(F32)
                acc = (acc + w[:, None] * a).astype(F32)
            out[b, h * G:(h + 1) * G] = (acc / np.maximum(l, F32(1e-30))[
                :, None])[:, :dh]
    return out


def _inputs(B, nh, nkv, dh, W, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(F32)
            for s in ((B, nh, dh), (B, W, nkv, dh), (B, W, nkv, dh))]


@pytest.mark.parametrize("W", [1, 8, 127, 128, 129, 384, 640, 1000, 1024])
def test_split_plan_covers_the_window_once(W):
    plan = tfd.split_plan(W)
    assert plan[0][0] == 0 and plan[-1][1] == W
    for (a0, a1), (b0, _) in zip(plan, plan[1:]):
        assert a1 == b0                     # no gap, no overlap
    assert all(0 < s1 - s0 <= tfd.SPLIT for s0, s1 in plan)
    assert all(s0 % tfd.SPLIT == 0 for s0, _ in plan)
    assert len(plan) == math.ceil(W / tfd.SPLIT)
    assert tfd.split_plan(W) == plan        # a function of W alone


@pytest.mark.parametrize("nv,W1,W2", [(1, 1, 640), (64, 64, 1024),
                                      (65, 300, 520), (576, 640, 1024)])
def test_splits_below_n_valid_do_not_depend_on_the_window(nv, W1, W2):
    """The splits a row of n_valid slots merges cover the same slots for
    any window W >= n_valid: what makes a row's bits independent of W."""
    def below(W):
        return [(s0, min(s1, nv)) for s0, s1 in tfd.split_plan(W) if s0 < nv]
    assert below(W1) == below(W2)
    assert below(W1)[-1][1] == nv


def test_split_matches_the_kernel_source():
    """The wrapper sizes grid and workspace by ``SPLIT``; the kernel
    partitions by its own compile-time constant."""
    src = (Path(tfd.__file__).resolve().parent.parent / "csrc"
           / "flash_decode.cu").read_text()
    found = re.findall(r"constexpr int SPLIT = (\d+);", src)
    assert found == [str(tfd.SPLIT)]


def test_workspace_depends_on_the_shapes_only():
    """(B, nh, splits, dh) sums and (B, nh, splits, 2) maxima and
    denominators: sized by (B, nh, W, dh), never by n_valid."""
    for B, nh, dh, W in ((8, 32, 80, 640), (8, 32, 128, 640), (1, 4, 64, 1),
                         (3, 14, 128, 1024)):
        q = torch.zeros((B, nh, dh))
        ws = tfd._workspace(q, W)
        assert ws.dtype == torch.float32
        assert ws.numel() == B * nh * len(tfd.split_plan(W)) * (dh + 2)


def test_wide_loads_where_rows_take_16_bytes():
    """16-byte loads for BLOOM's caches and a (32, 128)-tail corner view
    (head stride 128, d_head 80); element loads for a d_head that is not a
    multiple of 8 or a base that is not 16-byte aligned."""
    bf = torch.bfloat16
    slab = torch.zeros((2, 640, 32, 80), dtype=bf)
    assert tfd._wide(80, (slab, slab), (80,), 2) == 1
    tail = torch.zeros((10, 16, 32, 128), dtype=bf)
    corner = tail[..., :32, :80]
    assert tfd._wide(80, (corner, corner), corner.stride()[:3], 2) == 1
    assert tfd._wide(20, (slab, slab), (20,), 2) == 0
    odd = torch.zeros(64 * 80 + 1, dtype=bf)[1:].reshape(1, 64, 1, 80)
    assert tfd._wide(80, (odd, odd), (80,), 2) == 0
    f32 = torch.zeros((4, 16, 2, 20))
    assert tfd._wide(20, (f32, f32), f32.stride()[:3], 4) == 0


def _n_valids(W, B, rng):
    S = tfd.SPLIT
    return ([np.full(B, n, np.int32) for n in (1, S - 1, S, S + 1, W)]
            + [rng.integers(1, W + 1, size=B).astype(np.int32)])


@pytest.mark.parametrize("G", [1, 2, 4, 7, 12])
@pytest.mark.parametrize("dh", [64, 80, 128])
def test_mirror_vs_jax_oracle(G, dh):
    B, nkv, W = 2, 2, 384
    q, k, v = _inputs(B, G * nkv, nkv, dh, W, seed=G * 1000 + dh)
    rng = np.random.default_rng(dh)
    for nv in _n_valids(W, B, rng):
        want = np.asarray(ref.flash_decode_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(nv)))
        np.testing.assert_allclose(_mirror(q, k, v, nv), want, **TOL,
                                   err_msg=f"n_valid={nv}")
