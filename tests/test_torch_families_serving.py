"""The port's serving engine on the transformer family's other members
(GQA, qk-norm, sliding window, int8 KV cache, MoE, VLM), at float32 on the
reduced configs of ``tests/conftest.py``.

Within the port: ``generate == generate_reference``, chunked decode ==
``generate`` for k in {1, 3, 16}, paged == slab (qwen3 at kv_bits=8 with
its four arena leaves, and the paged-capable configs), refills that leave
live rows untouched.  Against the JAX package, on the same weights (the
JAX tree handed over through ``repro_torch.bridge``) and prompts: greedy
tokens, and the epoch runtime's served and dropped counts on one frozen
trace.  The JAX engine runs its ``use_kernel=False`` path."""
from __future__ import annotations

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)     # the xdist workers share the host's cores

import jax  # noqa: E402
import numpy as np  # noqa: E402

from conftest import REDUCTIONS, reduced_cfg  # noqa: E402
from repro.core.environment import paper_env as jpaper_env  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import kv_arena as jka  # noqa: E402
from repro.serving.runtime import EngineExecutor as JExec  # noqa: E402
from repro.serving.runtime import EpochRuntime as JRuntime  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import MoEConfig, get_arch  # noqa: E402
from repro_torch.core.environment import paper_env  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving.kv_arena import ZERO_PAGE, KVArena  # noqa: E402
from repro_torch.serving.runtime import EngineExecutor, EpochRuntime  # noqa: E402

NEW_ARCHS = ["deepseek-coder-33b", "mistral-large-123b", "qwen3-1.7b",
             "mixtral-8x22b", "granite-moe-1b-a400m", "internvl2-26b"]
ENGINE_KW = dict(batch_capacity=3, s_max=16, n_max=8)


def port_cfg(arch, **kw):
    cfg = get_arch(arch).scaled(**REDUCTIONS[arch])
    if cfg.is_moe and cfg.moe.n_experts > 4:
        cfg = dataclasses.replace(
            cfg, moe=MoEConfig(n_experts=4, top_k=min(cfg.moe.top_k, 2)))
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=16)
    return cfg.scaled(dtype="float32", **kw)


@functools.lru_cache(maxsize=None)
def _pair(arch, bits=8, kv_bits=16):
    """(JAX engine, port engine) on the same reduced float32 weights."""
    jcfg = reduced_cfg(arch).scaled(dtype="float32", kv_bits=kv_bits)
    je = jeng.ServingEngine(jcfg, quant_bits=bits, seed=3, **ENGINE_KW)
    tp = bridge.from_jax_params(jax.device_get(je._raw_params),
                                device="cpu")
    te = teng.ServingEngine(port_cfg(arch, kv_bits=kv_bits), params=tp,
                            quant_bits=bits, device="cpu", **ENGINE_KW)
    return je, te


def _prompts(seed, lens=(5, 16, 9)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, size=n).tolist() for n in lens]


def assert_same(a, b):
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    assert a.batch == b.batch


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_generate_matches_jax_engine(arch):
    """Greedy tokens equal the JAX engine's at float and W8 (the W8 tree
    of a d_head-128 config takes the fused tier's plain version)."""
    je, te = _pair(arch)
    for bits in (0, 8):
        for seed, caps in [(0, [10, 3, 7]), (2, [1, 10])]:
            prompts = _prompts(seed, (5, 16, 9) if seed != 2 else (20, 2))
            want = je.generate(prompts, caps, quant_bits=bits)
            got = te.generate(prompts, caps, quant_bits=bits)
            assert_same(got, want)


@pytest.mark.parametrize("bits", [0, 8, (8, 8), 4])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_generate_equals_generate_reference(arch, bits):
    _, te = _pair(arch)
    prompts = _prompts(4)
    for caps in ([10, 4, 0], [2, 10, 10]):
        assert_same(te.generate(prompts, caps, quant_bits=bits),
                    te.generate_reference(prompts, caps, quant_bits=bits))


@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_chunked_equals_generate(arch, k):
    """Chunked decode over the slab, driven to completion, equals
    ``generate`` bit for bit (for MoE, whose capacity dispatch couples the
    rows, too: every row steps the model in both)."""
    _, te = _pair(arch)
    prompts, caps = _prompts(7), [10, 6, 9]
    want = te.generate(prompts, caps)
    assert_same(te.generate_via_chunks(prompts, caps, k=k), want)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x22b",
                                  "qwen3-1.7b"])
def test_slab_refill_matches_jax_engine(arch):
    """A cohort refilled at step 3 into its empty slot: the same tokens as
    the JAX engine's refill (MoE rows share the capacity of every step, so
    the refill must leave the cohort's other rows where the JAX package
    leaves them)."""
    je, te = _pair(arch)
    prompts = _prompts(8)
    outs = []
    for eng in (je, te):
        st = eng.start_chunked(prompts[:2], [10, 10])
        st = eng.generate_chunked(st, 3)
        st = eng.refill_chunked(st, [2], prompts[2:], [8], t_now=3)
        while True:
            st = eng.generate_chunked(st, 4)
            out, lengths, done, t = eng.poll_chunked(st)
            if eng.exhausted(lengths, done, st.caps_host, t):
                break
        outs.append((np.asarray(out), np.asarray(lengths)))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])


def test_paged_capable_follows_reference():
    for arch in NEW_ARCHS:
        je, te = _pair(arch)
        assert te.paged_capable == je.paged_capable, arch
    assert not _pair("mixtral-8x22b")[1].paged_capable      # SWA, MoE
    assert not _pair("granite-moe-1b-a400m")[1].paged_capable


@pytest.mark.parametrize("k", [1, 16])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "internvl2-26b",
                                  "deepseek-coder-33b"])
def test_paged_equals_slab(arch, k):
    _, te = _pair(arch)
    arena = KVArena.for_engines(te, block_tokens=8)
    prompts, caps = _prompts(9), [10, 5, 8]
    for bits in (0, 8):
        want = te.generate(prompts, caps, quant_bits=bits)
        assert_same(te.generate_via_chunks(prompts, caps, k=k,
                                           quant_bits=bits, arena=arena),
                    want)
    assert arena.free_pages == arena.total_pages


@pytest.mark.parametrize("k", [1, 3, 16])
def test_paged_kv8_equals_slab(k):
    """qwen3 at kv_bits=8: the arena carries the int8 value pages and the
    scale pages, four leaves (the port's twin of
    ``tests/test_kv_arena.py::test_paged_engine_int8_kv_cache``); the
    paged path reproduces the slab's int8-KV decode bit for bit, also
    through a refill, and no decode-attention kernel entry point runs."""
    _, te = _pair("qwen3-1.7b", kv_bits=8)
    assert te.paged_capable and te.decode_tier() == "kv8"
    arena = KVArena.for_engines([te], block_tokens=8)
    bufs = arena.buffers()
    assert len(bufs) == 4 and set(bufs) == {"k", "v", "ks", "vs"}
    assert bufs["k"].dtype == torch.int8 and bufs["ks"].dtype == torch.float32
    assert bufs["ks"].shape == bufs["k"].shape[:-1]
    prompts = [[3, 1, 4, 1, 5], [9, 2], [7] * 16]
    ref = te.generate(prompts, [10, 5, 8])
    ops.reset_launch_counts()
    got = te.generate_via_chunks(prompts, [10, 5, 8], k=k, arena=arena)
    assert_same(got, ref)
    assert ops.launch_counts()["flash_decode_paged"] == 0
    assert ops.launch_counts()["flash_decode"] == 0
    # a refill at step 3, paged against slab
    outs = []
    for a in (None, arena):
        st = te.start_chunked(prompts[:2], [10, 10], arena=a)
        st = te.generate_chunked(st, 3)
        st = te.refill_chunked(st, [2], prompts[2:], [6], t_now=3)
        while True:
            st = te.generate_chunked(st, k)
            out, lengths, done, t = te.poll_chunked(st)
            if te.exhausted(lengths, done, st.caps_host, t):
                break
        if a is not None:
            te.release_all(st)
        outs.append((out, lengths))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    assert arena.free_pages == arena.total_pages
    assert not any(leaf[:, ZERO_PAGE].any() for leaf in bufs.values())


def test_kv8_arena_matches_jax_arena():
    """The int8-KV arena's leaves, shapes and dtypes equal the JAX
    package's for the same engine."""
    je, te = _pair("qwen3-1.7b", kv_bits=8)
    ja = jka.KVArena.for_engines([je], block_tokens=8)
    ta = KVArena.for_engines([te], block_tokens=8)
    jb = jax.device_get(ja.buffers())
    assert set(jb) == set(ta.buffers())
    for n, buf in ta.buffers().items():
        assert tuple(buf.shape) == tuple(jb[n].shape), n
        assert str(buf.dtype).split(".")[-1] == str(jb[n].dtype), n
    assert ta.n_pages == ja.n_pages


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_kv8_generate_matches_jax_engine(kv_bits):
    """qwen3's engine tokens equal the JAX engine's, with the int8 KV
    cache too."""
    je, te = _pair("qwen3-1.7b", kv_bits=kv_bits)
    prompts = _prompts(10)
    for bits in (0, 8):
        assert_same(te.generate(prompts, [10, 4, 7], quant_bits=bits),
                    je.generate(prompts, [10, 4, 7], quant_bits=bits))


def _trace_counts(m):
    return (m.arrived, m.served, m.dropped, m.truncated, m.generated_tokens,
            m.batch_sizes, m.served_by_method,
            [t.selected_rids for t in m.traces], m.final_queue_rids)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen3-1.7b"])
def test_epoch_runtime_matches_jax(arch):
    """EpochRuntime + dftsp + EngineExecutor at a fixed rate and seed: the
    same requests served, dropped and cut, and as many tokens, as the JAX
    package's runtime on its engine."""
    kw = dict(batch_capacity=4, s_max=24, n_max=12, quant_bits=8)
    jcfg = reduced_cfg(arch).scaled(dtype="float32")
    je = jeng.ServingEngine(jcfg, seed=0, **kw)
    te = teng.ServingEngine(
        port_cfg(arch), params=bridge.from_jax_params(
            jax.device_get(je._raw_params), device="cpu"),
        device="cpu", **kw)
    want = JRuntime(jpaper_env(arch), jget_policy("dftsp"),
                    JExec(je, seed=5)).run(rate=9.0, n_epochs=3, seed=7)
    got = EpochRuntime(paper_env(arch), get_policy("dftsp"),
                       EngineExecutor(te, seed=5)).run(rate=9.0, n_epochs=3,
                                                       seed=7)
    assert _trace_counts(got) == _trace_counts(want)
    assert got.served > 0 and got.generated_tokens > 0


def test_launcher_reductions_equal_the_test_suites():
    """``launch/serve.py --reduced`` cuts each arch to ``reduced_cfg``'s
    shape, and serves the new archs on the CPU."""
    from repro_torch.config import _ARCHS
    from repro_torch.launch import serve
    for arch in _ARCHS:
        a, b = reduced_cfg(arch), serve.reduced(get_arch(arch))
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
                  "d_ff", "vocab", "sliding_window", "qk_norm"):
            assert getattr(a, f) == getattr(b, f), (arch, f)
        assert (a.moe.n_experts, a.moe.top_k) == (b.moe.n_experts,
                                                  b.moe.top_k)
    for arch in ("granite-moe-1b-a400m", "internvl2-26b"):
        assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--epochs", "1", "--rate", "4", "--s-max", "16",
                           "--n-max", "4", "--batch-capacity", "2"]) == 0


def test_vlm_paged_refill_parts_from_slab_like_reference_f5():
    """F5's second face: a VLM's prompt pass also fills the cache slots
    [s_max, s_max + t) of a row refilled at cohort step t, which the slab
    keeps and the arena maps to the zero page, so the refilled row's
    tokens part between the two paths, in the JAX package as in the port;
    the other rows stay equal, and a refill with no whole gap block (t
    below the block size) keeps paged == slab.  The port's tokens equal
    the JAX package's on the slab at both steps and paged at t = 3.  The
    JAX package's own paged run at t = 5 gives one of two token sequences
    from one process to the next on the CPU, so there only the parting is
    held."""
    je, te = _pair("internvl2-26b", bits=0)
    prompts = _prompts(8)
    outs = {}
    for name, eng, arena_cls in (("jax", je, jka.KVArena),
                                 ("port", te, KVArena)):
        for paged in (False, True):
            for t_now in (5, 3):
                arena = arena_cls.for_engines([eng], block_tokens=4) \
                    if paged else None
                st = eng.start_chunked(prompts[:2], [8, 8], arena=arena)
                st = eng.generate_chunked(st, t_now)
                st = eng.refill_chunked(st, [2], prompts[2:], [3],
                                        t_now=t_now)
                while True:
                    st = eng.generate_chunked(st, 2)
                    out, lengths, done, t = eng.poll_chunked(st)
                    if eng.exhausted(lengths, done, st.caps_host, t):
                        break
                if paged:
                    eng.release_all(st)
                outs[name, paged, t_now] = np.asarray(out)
    for key in (("port", False, 5), ("port", False, 3), ("port", True, 3)):
        np.testing.assert_array_equal(outs[key], outs[("jax",) + key[1:]])
    for name in ("jax", "port"):
        slab, paged = outs[name, False, 5], outs[name, True, 5]
        np.testing.assert_array_equal(slab[:2], paged[:2])
        assert not np.array_equal(slab[2], paged[2])       # F5
        np.testing.assert_array_equal(outs[name, False, 3],
                                      outs[name, True, 3])
