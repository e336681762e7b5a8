"""The port's serving engine on the recurrent, hybrid and audio families
(xLSTM, Zamba2, Whisper), at float32 on the reduced configs of
``tests/conftest.py`` (and xLSTM / Zamba2 at 5 layers with every kind of
block, an sLSTM block and shared-attention sites: ``-mixed``).

Within the port: ``generate == generate_reference`` at every precision,
chunked decode == ``generate`` for k in {1, 3, 16}, a refilled xLSTM row ==
the same prompt served alone, a preempted-then-resumed row == an
uninterrupted one, every cache leaf's batch on axis 0, and neither the
eager loop nor a capture's warm-up changing a cache leaf of any of the six
families where the loop is not live (``t_end == t_dev``).  Against the JAX
package, on the same weights and prompts: greedy tokens, refilled
cohorts, and the epoch runtime's served and dropped counts on one frozen
trace.  These families serve
their quantized trees dequantized, with no kernel, on both sides."""
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
from repro.serving.runtime import EngineExecutor as JExec  # noqa: E402
from repro.serving.runtime import EpochRuntime as JRuntime  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import _ARCHS, EncDecConfig, get_arch  # noqa: E402
from repro_torch.core.environment import paper_env  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.launch.serve import reduced  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.quant.ptq import QTensor, tree_leaves  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving.kv_arena import KVArena  # noqa: E402
from repro_torch.serving.runtime import EngineExecutor, EpochRuntime  # noqa: E402

CASES = {"xlstm-1.3b": {}, "zamba2-7b": {}, "whisper-tiny": {},
         "xlstm-1.3b-mixed": dict(n_layers=5, xlstm=dict(slstm_every=2)),
         "zamba2-7b-mixed": dict(n_layers=5, hybrid=dict(attn_every=2))}
ENGINE_KW = dict(batch_capacity=3, s_max=16, n_max=8)


def _arch(case):
    return case.replace("-mixed", "")


def _scale(cfg, kw):
    """``cfg.scaled(**kw)``, a dict value replacing fields of that
    sub-config."""
    kw = {k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
          else v for k, v in kw.items()}
    return cfg.scaled(**kw)


def port_cfg(arch, **kw):
    cfg = get_arch(arch).scaled(**REDUCTIONS[arch])
    if cfg.family == "audio":
        cfg = dataclasses.replace(
            cfg, encdec=EncDecConfig(n_enc_layers=2, n_audio_frames=32))
    return _scale(cfg, dict(kw, dtype="float32"))


@functools.lru_cache(maxsize=None)
def _pair(case, bits=8):
    """(JAX engine, port engine) on the same reduced float32 weights."""
    arch, kw = _arch(case), CASES[case]
    jcfg = _scale(reduced_cfg(arch), dict(kw, dtype="float32"))
    je = jeng.ServingEngine(jcfg, quant_bits=bits, seed=3, **ENGINE_KW)
    tp = bridge.from_jax_params(jax.device_get(je._raw_params), device="cpu")
    te = teng.ServingEngine(port_cfg(arch, **kw), params=tp, quant_bits=bits,
                            device="cpu", **ENGINE_KW)
    return je, te


def _prompts(seed, lens=(5, 16, 9)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, size=n).tolist() for n in lens]


def assert_same(a, b):
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    assert a.batch == b.batch


def _drain(eng, st, k):
    while True:
        st = eng.generate_chunked(st, k)
        out, lengths, done, t = eng.poll_chunked(st)
        if eng.exhausted(lengths, done, st.caps_host, t):
            return np.asarray(out), np.asarray(lengths)


# ---------------------------------------------------------------------------
# Against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_generate_matches_jax_engine(case):
    """Greedy tokens equal the JAX engine's at float, W8 and W4."""
    je, te = _pair(case)
    for bits in (0, 8, 4):
        for seed, caps in [(0, [8, 3, 7]), (2, [1, 8])]:
            prompts = _prompts(seed, (5, 16, 9) if seed != 2 else (20, 2))
            assert_same(te.generate(prompts, caps, quant_bits=bits),
                        je.generate(prompts, caps, quant_bits=bits))


@pytest.mark.parametrize("case", ["xlstm-1.3b-mixed", "zamba2-7b-mixed",
                                  "whisper-tiny"])
def test_slab_refill_matches_jax_engine(case):
    """A cohort refilled at step 3 into its empty slot gives the JAX
    engine's tokens (Zamba2's and Whisper's refilled rows attend over the
    zero K/V of the slots between their prompt and the cohort's position,
    in both packages)."""
    je, te = _pair(case)
    prompts = _prompts(8)
    outs = []
    for eng in (je, te):
        st = eng.start_chunked(prompts[:2], [8, 8])
        st = eng.generate_chunked(st, 3)
        st = eng.refill_chunked(st, [2], prompts[2:], [5], t_now=3)
        outs.append(_drain(eng, st, 2))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])


def _trace_counts(m):
    return (m.arrived, m.served, m.dropped, m.truncated, m.generated_tokens,
            m.batch_sizes, m.served_by_method,
            [t.selected_rids for t in m.traces], m.final_queue_rids)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-7b"])
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


# ---------------------------------------------------------------------------
# The engine's own contracts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [0, 8, (8, 8), 4])
@pytest.mark.parametrize("case", list(CASES))
def test_generate_equals_generate_reference(case, bits):
    _, te = _pair(case)
    prompts = _prompts(4)
    for caps in ([8, 4, 0], [2, 8, 8]):
        assert_same(te.generate(prompts, caps, quant_bits=bits),
                    te.generate_reference(prompts, caps, quant_bits=bits))


@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("case", list(CASES))
def test_chunked_equals_generate(case, k):
    """Chunked decode driven to completion equals ``generate`` bit for bit;
    the eager loop's steps past each segment's exit are dead and change
    no state."""
    _, te = _pair(case)
    prompts, caps = _prompts(7), [8, 3, 6]
    assert_same(te.generate_via_chunks(prompts, caps, k=k),
                te.generate(prompts, caps))


@pytest.mark.parametrize("case", ["xlstm-1.3b", "xlstm-1.3b-mixed"])
def test_refill_recurrent_row_matches_solo_decode(case):
    """The twin of the JAX package's
    ``test_refill_recurrent_family_matches_solo_decode``: a recurrent
    state has no junk-attention slots, so a row refilled mid-cohort
    decodes bitwise as its prompt served alone."""
    _, te = _pair(case)
    st = te.start_chunked([[1, 2, 3]], n_tokens=[2])
    st = te.generate_chunked(st, 2)
    _, _, _, t = te.poll_chunked(st)
    st = te.refill_chunked(st, [1], [[7, 8]], [5], t_now=t)
    st = te.generate_chunked(st, te.n_max)
    out, lengths, _, _ = te.poll_chunked(st)
    solo = te.generate([[7, 8]], n_tokens=[5])
    assert lengths[1] == solo.lengths[0]
    np.testing.assert_array_equal(out[1, :lengths[1]],
                                  solo.tokens[0, :lengths[1]])


@pytest.mark.parametrize("case", ["xlstm-1.3b-mixed", "zamba2-7b-mixed",
                                  "whisper-tiny"])
def test_preempted_then_resumed_row_equals_uninterrupted(case):
    """A row evicted after 3 tokens and resumed in a fresh cohort with its
    delivered prefix as forced replay emits the uninterrupted row's
    tokens."""
    _, te = _pair(case)
    prompts, caps = _prompts(11), [8, 8, 8]
    want = te.generate(prompts, caps)
    st = te.start_chunked(prompts, caps)
    st = te.generate_chunked(st, 3)
    out, lengths, _, _ = te.poll_chunked(st)
    st = te.evict_slots(st, [1])
    prefix = out[1, :lengths[1]].tolist()
    st2 = te.start_chunked([prompts[1]], [caps[1]], prefixes=[prefix])
    got, glen = _drain(te, st2, 4)
    assert glen[0] == want.lengths[1]
    np.testing.assert_array_equal(got[0, :glen[0]],
                                  want.tokens[1, :glen[0]])


# ---------------------------------------------------------------------------
# Cache layout and dead steps, every family
# ---------------------------------------------------------------------------


def _every_family_engines():
    """One reduced float32 engine of each family (xLSTM and Zamba2 with
    every kind of block) and, for the transformer, its kv8 twin."""
    out = {}
    for arch, kw in (("bloom-3b", {}), ("granite-moe-1b-a400m", {}),
                     ("internvl2-26b", {}), ("qwen3-1.7b", dict(kv_bits=8)),
                     ("xlstm-1.3b", CASES["xlstm-1.3b-mixed"]),
                     ("zamba2-7b", CASES["zamba2-7b-mixed"]),
                     ("whisper-tiny", {})):
        cfg = _scale(reduced(get_arch(arch)), dict(kw, dtype="float32"))
        out[arch + ("-kv8" if kw.get("kv_bits") else "")] = \
            teng.ServingEngine(cfg, quant_bits=8, seed=2, device="cpu",
                               **ENGINE_KW)
    return out


ENGINES = ["bloom-3b", "granite-moe-1b-a400m", "internvl2-26b", "qwen3-1.7b-kv8",
           "xlstm-1.3b", "zamba2-7b", "whisper-tiny"]


@functools.lru_cache(maxsize=None)
def _engine(name):
    return _every_family_engines()[name]


def _snapshot(st):
    leaves = [t.clone() for layer in st.cache for t in layer.values()] \
        if hasattr(st, "cache") else [t.clone() for t in
                                      st.arena.buffers().values()]
    return leaves + [getattr(st, n).clone() for n in (
        "cur", "out", "lengths", "done", "t_dev")]


@pytest.mark.parametrize("name,paged", [(n, False) for n in ENGINES] + [
    (n, True) for n in ("bloom-3b", "internvl2-26b", "qwen3-1.7b-kv8")])
def test_dead_step_leaves_every_cache_leaf_unchanged(name, paged):
    """Where the loop is dead (``t_end == t_dev`` at a segment's end, or
    every row stopped), neither the eager loop (``_advance`` on the CPU)
    nor a capture's warm-up step (``_warm_up``, which runs the step and
    puts the cache back) changes a cache leaf or an emission tensor, bit
    for bit, in all six families (and the int8 KV cache), over the slab
    and, where the engine is paged-capable, over the arena."""
    eng = _engine(name)
    arena = KVArena.for_engines(eng, block_tokens=4) if paged else None
    st = eng.start_chunked(_prompts(12), [8, 2, 5], quant_bits=8,
                           arena=arena)
    st = eng.generate_chunked(st, 3)
    step = eng._model_step(st)

    def unchanged(run):
        before = _snapshot(st)
        run()
        return all(torch.equal(a, b) for a, b in zip(before, _snapshot(st)))

    # the segment is over: t_end == t_dev
    assert int(st.t_end) == int(st.t_dev) == 3
    assert unchanged(lambda: eng._advance(st, eng.n_max))
    assert unchanged(lambda: eng._warm_up(st, step))
    assert int(st.t_end) == 3
    # every row stopped: no row can emit
    st = eng.generate_chunked(st, eng.n_max)
    _, lengths, done, t = eng.poll_chunked(st)
    assert eng.exhausted(lengths, done, st.caps_host, t)
    st.t_end.fill_(eng.n_max)
    assert unchanged(lambda: eng._advance(st, eng.n_max))
    assert unchanged(lambda: eng._warm_up(st, step))
    if arena is not None:
        eng.release_all(st)


@pytest.mark.parametrize("arch", _ARCHS)
def test_every_cache_leaf_has_its_batch_on_axis_0(arch):
    """The twin of the JAX package's
    ``test_cache_batch_axes_derived_per_family``: where the JAX engine
    finds each leaf's batch axis by diffing shapes at two batch sizes, the
    port keeps it on axis 0 of every leaf of every family's cache, so the
    refill splice serves them all; the diff of shapes at batch 2 and 3
    finds axis 0 and nothing else."""
    m = build_model(reduced(get_arch(arch)))
    a, b = m.init_cache(2, 24, "cpu"), m.init_cache(3, 24, "cpu")
    assert isinstance(a, list) and len(a) == len(b) > 0
    for la, lb in zip(a, b):
        assert set(la) == set(lb)
        for name in la:
            sa, sb = tuple(la[name].shape), tuple(lb[name].shape)
            assert [i for i, (x, y) in enumerate(zip(sa, sb)) if x != y] \
                == [0], (arch, name, sa, sb)
            assert sa[0] == 2


# ---------------------------------------------------------------------------
# Weights, tiers, the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["xlstm-1.3b-mixed", "zamba2-7b-mixed",
                                  "whisper-tiny"])
def test_quantized_trees_are_dequantized_at_load(case):
    """These families serve fake-quant weights: no QTensor in any served
    tree, the JAX engine's dequantized values bitwise, W8A8 holding the
    W8A16 tensors; no decode-attention kernel tier, no paged path."""
    je, te = _pair(case)
    for bits in (8, (8, 8), 4):
        tree = te.params_for(bits)
        assert not any(isinstance(x, QTensor) for x in tree_leaves(tree))
    want = bridge.from_jax_params(jax.device_get(je.params_for(4)),
                                  device="cpu")
    for a, b in zip(tree_leaves(te.params_for(4)), tree_leaves(want)):
        assert (a is None and b is None) or torch.equal(a, b)
    assert all(a is b for a, b in zip(tree_leaves(te.params_for((8, 8))),
                                      tree_leaves(te.params_for(8))))
    assert te.decode_tier(8) == "none" and not te.paged_capable


def test_launcher_serves_the_new_archs():
    """``launch/serve.py --reduced`` serves xLSTM, Zamba2 and Whisper on
    the CPU."""
    from repro_torch.launch import serve
    for arch in ("xlstm-1.3b", "zamba2-7b", "whisper-tiny"):
        assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--epochs", "1", "--rate", "4", "--s-max", "16",
                           "--n-max", "4", "--batch-capacity", "2"]) == 0
