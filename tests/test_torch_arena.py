"""The port's paged KV arena against ``repro.serving.kv_arena``: the
allocator and block table, ``for_engines`` sizing, the engines' cap-aware
lease plans, and ``decode_step_paged`` logits on the same pages.

The JAX side's paged step runs ``use_kernel=False`` (its gather path): its
Pallas kernels do not run on this CPU.  The port's step runs through
``flash_decode_paged``'s plain version and, with ``use_kernel=False``,
through its own gather path.  Logits are held within 1e-4 at float32
(the two frameworks sum in different orders).
"""
from __future__ import annotations

import functools
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conftest import REDUCTIONS, reduced_cfg  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.quant import ptq as jptq  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import kv_arena as jka  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.quant import ptq as tptq  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import kv_arena as tka  # noqa: E402

TOL = 1e-4


def _both_arenas(n_pages=9, bt=8):
    jspecs = {n: jax.ShapeDtypeStruct((1, 1, 8, 2, 4), jnp.float32)
              for n in ("k", "v")}
    tspecs = {n: torch.empty((1, 1, 8, 2, 4), device="meta")
              for n in ("k", "v")}
    return (jka.KVArena(jspecs, n_pages, bt),
            tka.KVArena(tspecs, n_pages, bt, device="cpu"))


def test_reserved_pages_and_constants():
    assert (tka.ZERO_PAGE, tka.TRASH_PAGE, tka.N_RESERVED) == \
        (jka.ZERO_PAGE, jka.TRASH_PAGE, jka.N_RESERVED)
    ja, ta = _both_arenas()
    assert (ta.total_pages, ta.free_pages, ta.pages_in_use) == \
        (ja.total_pages, ja.free_pages, ja.pages_in_use)
    for name, leaf in ta.buffers().items():
        assert tuple(leaf.shape) == ja.buffers()[name].shape
        assert not leaf.any()                     # the zero page is zero


def test_alloc_free_order_is_lifo_like_jax():
    """The same sequence of allocs and frees leases the same page ids in
    the same order (hot pages stay hot), with the same peak."""
    ja, ta = _both_arenas(n_pages=12)
    rng = np.random.default_rng(0)
    held_j, held_t = [], []
    for _ in range(40):
        if held_j and rng.random() < 0.45:
            i = int(rng.integers(len(held_j)))
            ja.free(held_j.pop(i))
            ta.free(held_t.pop(i))
        else:
            n = int(rng.integers(0, 3))
            if n > ja.free_pages:
                continue
            a, b = ja.alloc(n), ta.alloc(n)
            assert a == b
            held_j.append(a)
            held_t.append(b)
        assert ta.free_pages == ja.free_pages
    assert ta.alloc_peak == ja.alloc_peak


@pytest.mark.parametrize("bad", ["double", "reserved", "out_of_range",
                                 "exhausted"])
def test_guards_raise_real_exceptions_like_jax(bad):
    """Misuse raises an ``ArenaError`` (not an assert, so it survives
    ``python -O``) on both sides, the same subclass for the same misuse."""
    raised = []
    for mod, arena in zip((jka, tka), _both_arenas(n_pages=6)):
        pages = arena.alloc(2)
        try:
            if bad == "double":
                arena.free(pages)
                arena.free(pages[:1])
            elif bad == "reserved":
                arena.free([mod.TRASH_PAGE])
            elif bad == "out_of_range":
                arena.free([6])
            else:
                arena.alloc(arena.free_pages + 1)
        except mod.ArenaError as e:
            raised.append(type(e).__name__)
    assert len(raised) == 2 and raised[0] == raised[1]
    assert raised[0] == ("ArenaExhausted" if bad == "exhausted"
                         else "ArenaError")


_UNDER_O = 'assert False, "asserts must be off"'
_GUARDS = """
import torch
from repro_torch.serving import kv_arena as ka
spec = torch.empty((1, 1, 8, 2, 4), device="meta")
a = ka.KVArena({"k": spec}, 5, 8)
p = a.alloc(2)
a.free(p)
for bad in ([p[0]], [ka.ZERO_PAGE], [5]):
    try:
        a.free(bad)
    except ka.ArenaError:
        continue
    raise SystemExit(f"no ArenaError for {bad}")
print("guards hold")
"""


def test_guards_survive_python_O():
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent
                                          / "src"))
    run = [sys.executable, "-O", "-c"]
    off = subprocess.run(run + [_UNDER_O], env=env, capture_output=True,
                         text=True, timeout=120)
    assert off.returncode == 0, off.stderr          # -O really strips asserts
    out = subprocess.run(run + [_GUARDS], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "guards hold" in out.stdout, out.stderr


def test_block_table_guards_and_lazy_device_mirror():
    jt = jka.BlockTable(3, 4, n_pages=9)
    tt = tka.BlockTable(3, 4, n_pages=9, device="cpu")
    for tbl in (jt, tt):
        tbl.set_row(1, [5, tka.ZERO_PAGE, 6, 7])
        tbl.extend_row(2, 1, [8, 3])
        with pytest.raises(RuntimeError):         # ArenaError on both
            tbl.set_row(0, [9, 2, 2, 2])
        with pytest.raises(RuntimeError):
            tbl.extend_row(0, 0, [-1])
    np.testing.assert_array_equal(tt.host, jt.host)
    assert tt.row_leases(1) == jt.row_leases(1) == [5, 6, 7]
    dev = tt.device
    assert dev.dtype == torch.int32 and tt.device is dev   # not re-shipped
    np.testing.assert_array_equal(dev.numpy(), np.asarray(jt.device))
    tt.clear_row(1)
    assert tt.device is dev           # a row changed: re-shipped in place
    assert (tt.device[1] == tka.TRASH_PAGE).all()


# -- sizing and lease plans ---------------------------------------------------

# two reduced engines with different d_head on one node (BLOOM-3B's 80 and
# a wider 96), as a node hosting BLOOM-3B beside a wider model has
PAIR = {"a": dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                  vocab=256),
        "b": dict(n_layers=2, d_model=96, n_heads=1, n_kv_heads=1, d_ff=128,
                  vocab=256, d_head=96)}
PAIR_KW = {"a": dict(batch_capacity=3, s_max=16, n_max=16),
           "b": dict(batch_capacity=2, s_max=24, n_max=8)}


@pytest.mark.parametrize("bt,shrink", [(8, 0.5), (16, 1.0), (4, 0.3)])
def test_for_engines_matches_jax(bt, shrink):
    jengs = {m: jeng.ServingEngine(
        reduced_cfg("bloom-3b").scaled(**PAIR[m]), **PAIR_KW[m])
        for m in PAIR}
    tengs = {m: teng.ServingEngine(
        get_arch("bloom-3b").scaled(**PAIR[m]), device="cpu", **PAIR_KW[m])
        for m in PAIR}
    assert tengs["a"].cfg.d_head != tengs["b"].cfg.d_head
    ja = jka.KVArena.for_engines(jengs, block_tokens=bt, shrink=shrink)
    ta = tka.KVArena.for_engines(tengs, block_tokens=bt, shrink=shrink)
    assert ta.n_pages == ja.n_pages and ta.block_tokens == ja.block_tokens
    for name, leaf in ja.buffers().items():
        got = ta.buffers()[name]
        assert tuple(got.shape) == leaf.shape     # elementwise-max tail
        assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
    with pytest.raises(ValueError, match="divisible"):
        tka.KVArena.for_engines(tengs, block_tokens=7)


def test_lease_plans_match_jax_over_a_grid():
    kw = dict(batch_capacity=2, s_max=20, n_max=12)
    je = jeng.tiny_engine("bloom-3b", **kw)
    te = teng.tiny_engine("bloom-3b", device="cpu", **kw)
    for bt in (4, 8, 16):
        if te.cache_len % bt:
            continue
        arena = types.SimpleNamespace(block_tokens=bt)
        for t in range(0, kw["n_max"] + 2):
            for cap in (0, 1, 3, 5, 12, 20):
                assert te.pages_for_admission(t, cap, bt) == \
                    je.pages_for_admission(t, cap, bt), (t, cap, bt)
                a, b = te._lease_row(arena, t, cap), je._lease_row(arena, t,
                                                                   cap)
                assert a[0] == b[0] and a[2:] == b[2:], (t, cap, bt)
                np.testing.assert_array_equal(a[1], b[1])


# -- decode_step_paged against the JAX gather path ---------------------------

B, BT, NB = 3, 4, 6          # W = 24 slots, in blocks of 4


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = reduced_cfg("bloom-3b").scaled(dtype="float32")
    p = jtr.init_params(cfg, jax.random.key(2))
    tp = bridge.from_jax_params(jax.device_get(p), device="cpu")
    return cfg, p, tp


def _trees(bits):
    cfg, p, tp = _setup()
    if bits == 0:
        return cfg, p, tp
    return cfg, jptq.dequantize_tree(jptq.quantize_tree(p, bits)), \
        tptq.quantize_tree(tp, bits)


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_decode_step_paged_logits_match_jax(bits):
    """Random pages and a scrambled table (dead rows on the trash page),
    carried across by ``bridge.arena_pages_from_jax``: the port's paged
    step gives the JAX paged step's logits and writes the same pages."""
    jcfg, jp, tp = _trees(bits)
    tcfg = get_arch("bloom-3b").scaled(**REDUCTIONS["bloom-3b"],
                                       dtype="float32")
    L, nkv, dh = jcfg.n_layers, jcfg.n_kv_heads, jcfg.d_head
    rng = np.random.default_rng(bits)
    P = tka.N_RESERVED + B * NB
    pages = {n: rng.standard_normal((L, P, BT, nkv, dh)).astype(np.float32)
             for n in ("k", "v")}
    table = (tka.N_RESERVED + rng.permutation(B * NB)).reshape(B, NB)
    table[2] = tka.TRASH_PAGE                      # a dead row
    table = table.astype(np.int32)
    tok = rng.integers(1, jcfg.vocab, size=(B, 1)).astype(np.int32)
    spec = torch.empty((L, 1, NB * BT, nkv, dh), device="meta")
    for pos in (9, 23):
        lj, pj = jtr.decode_step_paged(
            jcfg, jp, {n: jnp.asarray(a) for n, a in pages.items()},
            jnp.asarray(table), jnp.asarray(tok), jnp.int32(pos))
        for use_kernel in (True, False):
            arena = tka.KVArena({"k": spec, "v": spec}, P, BT)
            bridge.arena_pages_from_jax(arena, pages)
            lt, pt = ttr.decode_step_paged(
                tcfg, tp, arena.buffers(), torch.from_numpy(table),
                torch.from_numpy(tok), pos, use_kernel=use_kernel)
            np.testing.assert_allclose(lt[:2].numpy(), np.asarray(lj)[:2],
                                       rtol=TOL, atol=TOL)
            live = np.delete(np.arange(P), tka.TRASH_PAGE)
            for n in ("k", "v"):
                np.testing.assert_allclose(
                    pt[n][:, live].numpy(), np.asarray(pj[n])[:, live],
                    rtol=TOL, atol=TOL)
