"""Batched-inference engine (port of ``repro.serving.engine``): executes
scheduled batches on the PyTorch model.

A scheduled batch of prompts is padded to the epoch's s' (the paper's
'extend all prompts to the maximum length' assumption), prefilled in one
pass, then decoded greedily with sampling, EOS detection and per-request
output caps all on the device.  Per ``generate`` call there is exactly ONE
host->device copy (prompts and caps, in one tensor) and ONE device->host
copy (tokens and lengths, in one tensor).

The decode loop runs on the device.  One function, ``_step``, is a decode
step: emission, EOS, caps, forced replay, the model, the argmax and the
advance of the cohort's step counter, all in place on tensors whose
addresses stay fixed for the life of the loop.  On CUDA it is captured
once as a CUDA graph (per cohort and precision; ``generate`` keeps one
loop per engine) and wrapped in a device-side WHILE node
(``kernels.decode_loop.DeviceLoop``): one launch runs the loop to its
exit, and the host issues no ATen op and reads no device value inside it.
On the CPU the same function runs eagerly, in ``_advance_eager``, the
engine's eager loop.  ``generate_reference`` is the host-driven loop with
one device->host copy per token, kept as the oracle ``generate`` must
equal bit for bit.

The same loop exists in re-entrant form for continuous batching:
``start_chunked`` prefills a cohort into a ``DecodeState`` (or, with
``arena=``, a ``PagedDecodeState`` whose KV lives in a node-wide
``KVArena``), ``generate_chunked(state, k)`` advances it by at most k
tokens, ``poll_chunked`` reads its progress back, and ``refill_chunked``
prefills new prompts into slots freed by finished rows of the live cohort.
Prefill, refill, eviction and a block-table re-ship write into the
cohort's tensors in place.  Host copies: one host->device copy per
``start_chunked`` / ``refill_chunked`` (prompts, caps, refill mask,
forced-replay buffers and page-scatter ids in one tensor), one
device->host copy per ``poll_chunked``, a block-table re-ship only at a
boundary where table rows changed, and none inside a segment.

The early exit is the JAX package's: the step counter ``t_dev`` lives on
the device and advances only while the loop is live (some row can emit,
and ``t_dev < t_end``), and the device loop stops as soon as it is not.
So the tokens, the lengths and the ``t`` that ``poll_chunked`` reports
equal the JAX package's, also where every row stops before ``t_end``, and
a stopped cohort costs no further step.  The CPU's eager loop runs a
host-known number of steps; those past the exit are dead and change
nothing.

Weights can be served quantized: ``quant_bits`` picks the default
precision and ``generate(..., quant_bits=...)`` serves one batch at the
precision the scheduler decided.  Each precision is quantized once from
the full-precision weights and cached (``params_for``).  A precision is an
int (weight bits) or a ``(weight_bits, act_bits)`` pair; ``(8, 8)`` is
W8A8.  What a model family is, the engine asks ``models.api.Model``,
whose docstring states each family's facts.

Every data-plane entry (``generate``, ``start_chunked``,
``refill_chunked``, ``generate_chunked``, ``poll_chunked``) is a root span
of the tracer (``serving.trace``); a capture is a span ``engine.capture``
with a child ``engine.capture.warm_up``.  On CUDA the work the host
enqueues without waiting is timed on the device: ``dev.prefill`` (the
host->device copy, the prefill and its scatter or splice),
``dev.decode`` (the device loop's launch) and ``dev.read_back`` (the one
device->host copy), read only after that copy; each read-back counts the
loop iterations it found, and each prefill the rows it admitted.

A step that is not live changes no cache leaf.  The step itself writes
the cache whether live or not (a recurrent state has no slot that no live
row reads, so a dead step would advance it), so the loops keep dead steps
from the cache: the device loop tests its condition before every
iteration and runs none; the eager loop, which reads no device value,
puts every leaf back from a copy where a step was dead; the warm-up step
before a capture puts every leaf back from a copy.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import ModelConfig, get_arch
from repro_torch.kernels import ops as kops
from repro_torch.kernels.decode_loop import DeviceLoop, kernel_nodes
from repro_torch.models.api import Model, build_model
from repro_torch.quant.ptq import QTensor, dequantize_tree, quantize_tree, \
    with_act_bits
from repro_torch.serving import trace
from repro_torch.serving.kv_arena import TRASH_PAGE, ZERO_PAGE, BlockTable, \
    KVArena


@dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, n_max) generated ids (post-prompt)
    lengths: np.ndarray         # (B,) emitted length per request
    batch: int


@dataclass
class DecodeState:
    """Re-entrant decode state of one batch cohort.

    Produced by ``start_chunked`` and advanced by ``generate_chunked``;
    the tensors live on the engine's device and keep their addresses for
    the cohort's life (a captured step reads and writes them in place), so
    re-entering costs no transfer.  A state passed to ``generate_chunked``,
    ``refill_chunked`` or ``evict_slots`` is CONSUMED (its tensors are
    updated in place): always continue from the returned state.

    On the device: the rows' emission state and ``t_dev``, the cohort's
    decode step (the shared KV-cache write position is ``s_max + t_dev``,
    bounded by ``n_max``), which advances only while some row can emit, as
    the JAX package's ``t`` does; ``t_end`` bounds the running segment.
    On the host: ``t``, an upper bound on ``t_dev`` (the last segment's
    end, or the ``t_now`` of the last refill), which the lease top-ups
    cover from, as the JAX package's ``t_host``; ``poll_chunked`` reads
    ``t_dev`` itself.  Rows track their own emission
    through ``lengths``, so rows admitted mid-cohort emit into their row of
    ``out`` from 0 whatever ``t_dev`` is.  While ``lengths[i] <
    n_forced[i]`` a row emits ``forced[i, lengths[i]]`` instead of its
    argmax: the preemption-resume replay that keeps an already-delivered
    prefix exact (all zero outside resume).  ``graphs`` holds the
    cohort's device loop per precision (CUDA only).
    """
    cache: Any                  # per-layer KV slot caches, full batch capacity
    cur: torch.Tensor           # (B,) next token to emit per row
    out: torch.Tensor           # (B, n_max) emitted tokens per row
    lengths: torch.Tensor       # (B,) emitted count per row
    done: torch.Tensor          # (B,) bool, EOS seen
    caps: torch.Tensor          # (B,) per-row output cap (0 = empty slot)
    t: int = 0                  # host upper bound on t_dev
    bits: Any = 0               # precision spec (int or (w, a) pair)
    caps_host: np.ndarray = None  # host mirror of caps
    forced: torch.Tensor = None   # (B, n_max) forced-replay tokens
    n_forced: torch.Tensor = None  # (B,) forced-prefix length per row
    t_dev: torch.Tensor = None    # () int32 cohort decode step
    t_end: torch.Tensor = None    # () int32 bound of the running segment
    graphs: dict = None           # precision -> captured step (CUDA)

    @property
    def batch_capacity(self) -> int:
        return int(self.caps_host.shape[0])


@dataclass
class PagedDecodeState:
    """Arena-backed sibling of :class:`DecodeState`: the cohort's KV lives
    in its node-wide :class:`KVArena`, and the state holds the cohort's
    :class:`BlockTable` (whose device copy keeps its address across
    re-ships) and the same per-row emission fields.  Rows lease pages at
    admission and return them through ``release_slots`` the moment they
    complete.  Cap-aware incremental leasing: per row, ``lease_end`` is one
    past the highest block leased and ``lease_last`` one past the last
    block its cap can ever need; blocks in ``[lease_end, lease_last)`` are
    TRASH in the table until a segment-boundary top-up
    (``_extend_leases``) leases them."""
    arena: KVArena
    table: BlockTable
    cur: torch.Tensor
    out: torch.Tensor
    lengths: torch.Tensor
    done: torch.Tensor
    caps: torch.Tensor
    t: int = 0
    bits: Any = 0
    caps_host: np.ndarray = None
    forced: torch.Tensor = None
    n_forced: torch.Tensor = None
    t_dev: torch.Tensor = None
    t_end: torch.Tensor = None
    graphs: dict = None
    lease_end: np.ndarray = None   # (B,) next block index to lease
    lease_last: np.ndarray = None  # (B,) one past last block of the cap

    @property
    def batch_capacity(self) -> int:
        return int(self.caps_host.shape[0])


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no quiet
    fallback to the CPU: pass ``device="cpu"`` to run there)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def tiny_engine(arch_id: str, **engine_kw) -> "ServingEngine":
    """A CPU-sized reduced engine for ``arch_id`` (1 layer, d_model 64,
    vocab 256), the same reduced shape as the JAX package's
    ``tiny_engine``.  ``engine_kw`` passes through to ``ServingEngine``."""
    cfg = get_arch(arch_id).scaled(n_layers=1, d_model=64, n_heads=2,
                                   n_kv_heads=2, d_ff=128, vocab=256)
    return ServingEngine(cfg, **engine_kw)


class ServingEngine:
    """Fixed-shape batched prefill + masked greedy decode for one model."""

    def __init__(self, cfg: ModelConfig, params: Any = None,
                 batch_capacity: int = 8, s_max: int = 512,
                 n_max: int = 128, quant_bits: int = 0,
                 eos_id: int = 0, seed: int = 0,
                 use_kernel: bool = True, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model: Model = build_model(cfg)
        self.batch_capacity = batch_capacity
        self.s_max = s_max
        self.n_max = n_max
        self.eos_id = eos_id
        # use_kernel=False (the plain masked softmax) serves the CPU only
        if not use_kernel and self.device.type == "cuda" \
                and self.model.kernel_weights:
            raise ValueError("use_kernel=False runs on the CPU only; on "
                             "CUDA decode attention is the flash_decode "
                             "kernel")
        self.use_kernel = bool(use_kernel)
        self._decode_kw = {"use_kernel": self.use_kernel} \
            if self.model.kernel_weights else {}
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen)
        self._raw_params = params            # full precision master copy
        self._params_cache: dict = {}        # precision -> param tree
        self.default_bits = self._canon_bits(quant_bits)
        self.params = self.params_for(quant_bits)
        self.precisions_served: set = set()  # precisions generate() ran at
        self.cache_len = s_max + n_max
        self.lease_topups = 0                # pages leased by top-ups
        self._gen: Optional[DecodeState] = None  # generate's decode loop
        self._graph_pool = None              # one pool for all its graphs
        self._last_loop = None               # keeps the pool in use
        self.captures: list = []             # one record per captured step

    # -- multi-precision weight cache ---------------------------------------

    @staticmethod
    def _canon_bits(bits):
        """Canonical precision spec: an int (weight bits; 0/16 both mean
        full precision) or a ``(weight_bits, act_bits)`` pair (a
        QuantMethod.serve_bits; W8A8 serves as ``(8, 8)``).  A pair with
        fp activations collapses to its int; ``(8, 8)`` stays distinct
        from ``8`` on every device, since both run as quantized trees."""
        if isinstance(bits, (tuple, list)):
            w, a = bits
            w = 0 if not w or w >= 16 else int(w)
            a = 16 if not a or a >= 16 else int(a)
            if w == 0 or a == 16:
                return w
            return (w, a)
        return 0 if not bits or bits >= 16 else int(bits)

    def params_for(self, bits):
        """Weights at ``bits`` precision (int or (w, a) pair), quantized
        once and cached so the scheduler can swap the served method every
        epoch.  Without the model's ``kernel_weights`` the trees are
        dequantized at load (fake-quant weights in the model dtype, as in
        the JAX package); their W8A8 tree is the W8A16 one."""
        bits = self._canon_bits(bits)
        if bits not in self._params_cache:
            if bits == 0:
                p = self._raw_params
            elif isinstance(bits, int):
                p = quantize_tree(self._raw_params, bits)
                if not self.model.kernel_weights:
                    p = dequantize_tree(p)
            else:
                # int8 activations quantize the weights as fp ones do: the
                # fp-activation tree's q, scales and kept embedding table,
                # tagged, so the two precisions hold one copy between them
                base = self.params_for(bits[0])
                if isinstance(base.get("embed"), QTensor):
                    base["embed"].dense()
                p = with_act_bits(base, bits[1])
            self._params_cache[bits] = p
        return self._params_cache[bits]

    def kept_tables(self) -> dict:
        """The dequantized embedding table each cached precision keeps, by
        precision (only those made so far); precisions that share one map
        to the same tensor."""
        return {bits: p["embed"]._dense
                for bits, p in self._params_cache.items()
                if isinstance(p.get("embed"), QTensor)
                and p["embed"]._dense is not None}

    def decode_tier(self, bits=None) -> str:
        """The model's ``decode_tier`` at ``bits`` (engine default when
        None): ``"kv8"`` (int8 KV cache, no decode-attention kernel),
        ``"fused"`` (K6/K7), ``"flash"`` (K4/K5) or ``"none"``."""
        return self.model.decode_tier(self.params_for(
            self.default_bits if bits is None else bits))

    # -- public API ----------------------------------------------------------

    def synth_prompts(self, requests: Sequence, rng: np.random.Generator):
        """Synthesize random-token prompts + output caps for scheduled
        requests, clamped to this engine's static shapes."""
        prompts = [rng.integers(1, self.cfg.vocab,
                                size=min(r.s, self.s_max)).tolist()
                   for r in requests]
        caps = [min(r.n, self.n_max) for r in requests]
        return prompts, caps

    def pad_prompts(self, prompts: Sequence[Sequence[int]]) -> np.ndarray:
        """Left-truncate/right-align prompts to (batch_capacity, s_max)."""
        B = self.batch_capacity
        out = np.zeros((B, self.s_max), np.int32)
        for i, p in enumerate(prompts[:B]):
            p = list(p)[-self.s_max:]
            out[i, -len(p):] = p        # right-aligned => last slot is last
        return out

    def _prepare(self, prompts, n_tokens, quant_bits):
        """Resolve the weights and build the host batch: (params, padded
        prompts with the caps as one extra column (B, s_max + 1) int32,
        host caps, batch size, canonical precision)."""
        bits = self.default_bits if quant_bits is None \
            else self._canon_bits(quant_bits)
        params = self.params_for(bits)
        self.precisions_served.add(bits)
        B = self.batch_capacity
        nb = len(prompts)
        assert nb <= B, (nb, B)
        caps = np.full((B,), self.n_max, np.int32)
        if n_tokens is not None:
            caps[:nb] = np.minimum(np.asarray(n_tokens, np.int32), self.n_max)
        caps[nb:] = 0
        host = np.concatenate([self.pad_prompts(prompts), caps[:, None]], 1)
        return params, torch.from_numpy(host), caps, nb, bits

    def _prefill(self, params, tokens, out=None):
        """Prompt pass; returns (first sampled token (B,), KV cache).
        ``out``: a KV cache to fill in place."""
        logits, cache = self.model.prefill(
            params, self.model.prompt_batch(tokens), self.cache_len, out=out)
        return torch.argmax(logits[..., :self.cfg.vocab], -1), cache

    def _decode(self, params, cache, cur, t):
        logits, cache = self.model.decode_step(
            params, cache, cur[:, None], self.s_max + t, **self._decode_kw)
        return torch.argmax(logits[..., :self.cfg.vocab], -1), cache

    # -- the decode loop -----------------------------------------------------

    def _emission(self, cur, caps, forced=None, n_forced=None) -> dict:
        """A loop's fresh emission tensors for first tokens ``cur`` and caps
        ``caps`` (copied: the loop owns its tensors)."""
        B, dev = self.batch_capacity, self.device
        return dict(
            cur=cur.clone(), caps=caps.to(torch.int32).clone(),
            out=torch.zeros((B, self.n_max), dtype=cur.dtype, device=dev),
            lengths=torch.zeros((B,), dtype=cur.dtype, device=dev),
            done=torch.zeros((B,), dtype=torch.bool, device=dev),
            forced=(torch.zeros((B, self.n_max), dtype=torch.int32,
                                device=dev) if forced is None
                    else forced.clone()),
            n_forced=(torch.zeros((B,), dtype=torch.int32, device=dev)
                      if n_forced is None else n_forced.clone()),
            t_dev=torch.zeros((), dtype=torch.int32, device=dev),
            t_end=torch.zeros((), dtype=torch.int32, device=dev),
            graphs={})

    def _step(self, state, model_step) -> None:
        """One decode step of ``state``, in place on its tensors, with no
        host transfer: the one step body of ``generate`` and
        ``generate_chunked`` (slab and paged), run eagerly on the CPU and
        captured once on CUDA.

        The loop is live while some row can emit and ``t_dev < t_end``
        (the JAX package's ``cond``).  A live step emits at each alive
        row's own ``lengths[i]`` (its forced token while replaying), retires
        rows on EOS and caps, feeds the emitted tokens through
        ``model_step(tokens, pos)`` at position ``s_max + t_dev`` and
        advances ``t_dev``.  A step that is not live leaves cur, out,
        lengths, done and ``t_dev`` as they were, but its model call still
        writes the cache (the position is held below ``s_max + n_max``):
        the loops put that back (``_advance_eager``, ``_warm_up``)."""
        cur, out, lengths, done = state.cur, state.out, state.lengths, \
            state.done
        live = self._live(state)
        alive = (~done) & (lengths < state.caps) & live
        idx = torch.clamp(lengths, max=self.n_max - 1)[:, None]
        fed = torch.where(lengths < state.n_forced,
                          torch.gather(state.forced, 1, idx)[:, 0]
                          .to(cur.dtype), cur)
        out.scatter_(1, idx, torch.where(
            alive, fed, torch.gather(out, 1, idx)[:, 0])[:, None])
        lengths += alive
        done |= (fed == self.eos_id) & alive
        pos = self.s_max + torch.clamp(state.t_dev, max=self.n_max - 1)
        torch.where(live, model_step(fed[:, None], pos), cur, out=cur)
        state.t_dev += live

    @staticmethod
    def _live(state) -> torch.Tensor:
        """Whether ``state``'s loop is live, a 0-d bool tensor: some row
        can emit and ``t_dev < t_end``."""
        alive = (~state.done) & (state.lengths < state.caps)
        return alive.any() & (state.t_dev < state.t_end)

    def _model_step(self, state):
        """``(tokens, pos) -> next tokens`` of ``state`` at its precision:
        ``decode_step`` on its slab cache, or ``decode_step_paged`` on its
        arena's buffers through its block table's device copy."""
        params = self.params_for(state.bits)
        kw = self._decode_kw
        if isinstance(state, PagedDecodeState):
            pages, table = state.arena.buffers(), state.table.device

            def run(tokens, pos):
                return self.model.decode_step_paged(params, pages, table,
                                                    tokens, pos, **kw)[0]
        else:
            def run(tokens, pos):
                return self.model.decode_step(params, state.cache, tokens,
                                              pos, **kw)[0]

        def step(tokens, pos):
            return torch.argmax(run(tokens, pos)[..., :self.cfg.vocab], -1)
        return step

    def _advance_eager(self, state, n_steps: int) -> None:
        """The eager loop: ``n_steps`` steps of ``state``, one ATen op
        after another (the CPU's loop).  It reads no device value, so it
        runs on past the exit: each step's cache leaves are copied first
        and put back where the step is not live."""
        step = self._model_step(state)
        leaves = self._cache_leaves(state)
        saved = [torch.empty_like(leaf) for leaf in leaves]
        for _ in range(n_steps):
            live = self._live(state)
            for old, leaf in zip(saved, leaves):
                old.copy_(leaf)
            self._step(state, step)
            for leaf, old in zip(leaves, saved):
                torch.where(live, leaf, old, out=leaf)

    @staticmethod
    def _cache_leaves(state) -> list:
        """Every cache tensor a step of ``state`` writes: its slab cache's
        leaves, or its arena's buffers."""
        if isinstance(state, PagedDecodeState):
            return list(state.arena.buffers().values())
        return [leaf for layer in state.cache for leaf in layer.values()]

    def _warm_up(self, state, step) -> None:
        """Run one step of ``state`` with its loop dead (``t_end = t_dev``:
        it emits nothing and moves no counter), on a side stream on CUDA,
        so that every kernel's library is loaded before a capture; then
        put back every cache leaf it wrote from a copy taken before (one
        cohort's cache, or the arena, held for the step; made and freed on
        the current stream)."""
        bound = state.t_end.clone()
        state.t_end.copy_(state.t_dev)
        leaves = self._cache_leaves(state)
        saved = [leaf.clone() for leaf in leaves]
        if self.device.type == "cuda":
            here = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(here)
            with torch.cuda.stream(side):
                self._step(state, step)
            here.wait_stream(side)
        else:
            self._step(state, step)
        for leaf, old in zip(leaves, saved):
            leaf.copy_(old)
        state.t_end.copy_(bound)

    def _advance(self, state, n_steps: int) -> None:
        """Run ``state``'s loop: on CUDA, one launch of its device loop at
        its precision (captured at the first call of each precision),
        which stops on the device once the loop is not live; on the CPU,
        the eager loop, ``n_steps`` steps (at least every step that can be
        live; the others are dead and change nothing)."""
        if n_steps <= 0:
            return
        if self.device.type != "cuda":
            self._advance_eager(state, n_steps)
            return
        loop = state.graphs.get(state.bits)
        if loop is None:
            loop = state.graphs[state.bits] = self._capture(state)
        with trace.device("dev.decode", self.device):
            loop.launch()

    def _capture(self, state) -> DeviceLoop:
        """Capture one step of ``state`` at its precision as a CUDA graph
        in the engine's graph pool and wrap it in a device loop.  The step
        is first run once by ``_warm_up``, which leaves every cache leaf as
        it found it, so the loop's first launch starts from the state it
        was given; the capture itself launches nothing, so the launches the
        wrappers count while it runs are taken back and kept as the loop's
        own (the warm-up's stay counted).  A failed capture raises: there
        is no eager fallback on CUDA.  The engine holds the loop it
        captured last until the next capture succeeds: a pool whose graphs
        are all freed (every cohort drained) cannot take another capture.
        ``captures`` records the span's host ms, warm-up included, and the
        kernel nodes of the captured step (``kernel_nodes``, read after the
        span; also a count ``nodes`` of the tracer) and, where the model
        counts them (``state_bytes``), the bytes of recurrent state the step
        reads and writes (``ssm_state_bytes``; also a count of the
        tracer)."""
        with trace.span("engine.capture") as timing:
            step = self._model_step(state)
            with trace.span("engine.capture.warm_up"):
                self._warm_up(state, step)
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            before = kops.launch_counts()
            with torch.cuda.graph(graph, pool=self._graph_pool):
                self._step(state, step)
            launches = {k: v - before[k]
                        for k, v in kops.launch_counts().items()
                        if v != before[k]}
            kops.add_launch_counts(launches, -1)
            loop = DeviceLoop(graph, state.t_dev, state.t_end, state.lengths,
                              state.caps, state.done, launches)
        self._last_loop = loop
        nodes = kernel_nodes(graph)
        trace.count("nodes", nodes)
        paged = isinstance(state, PagedDecodeState)
        self.captures.append(dict(bits=state.bits, ms=timing.ms, paged=paged,
                                  nodes=nodes))
        n = None if paged else self.model.state_bytes(state.cache)
        if n is not None:
            trace.count("ssm_state_bytes", n)
            self.captures[-1]["ssm_state_bytes"] = n
        return loop

    def _read_back(self, state, cols) -> np.ndarray:
        """The one device->host copy of a loop's results: the (B, c)
        integer blocks ``cols``, side by side, and the iteration count of
        each of the state's device loops, whose launches are then counted
        (``DeviceLoop.count``).  Returns the blocks as one int32 array."""
        B = state.lengths.shape[0]
        loops = list(state.graphs.values())
        blocks = [c.to(torch.int64) for c in cols] + [
            loop.iters.reshape(1, 1).expand(B, 1) for loop in loops]
        with trace.read_back(self.device):
            res = torch.cat(blocks, 1).cpu().numpy()  # the one D2H copy
        n = res.shape[1] - len(loops)
        iters = 0
        for i, loop in enumerate(loops):
            iters += int(res[0, n + i]) - loop.counted
            loop.count(res[0, n + i])
        if loops:
            trace.count("iters", iters)
        return res[:, :n].astype(np.int32)

    def _generate_state(self, bits, cur, caps) -> DecodeState:
        """``generate``'s decode loop, owned by the engine and reused by
        every call (its captured steps with it), reset in place for a batch
        with first tokens ``cur`` and caps ``caps``; its cache was filled
        in place by the prefill."""
        st = self._gen
        st.bits = bits
        st.cur.copy_(cur)
        st.caps.copy_(caps)
        for t in (st.out, st.lengths, st.done, st.forced, st.n_forced,
                  st.t_dev):
            t.zero_()
        st.t_end.fill_(self.n_max)
        return st

    @torch.no_grad()
    @trace.traced("engine.generate")
    def generate(self, prompts: Sequence[Sequence[int]],
                 n_tokens: Optional[Sequence[int]] = None,
                 greedy: bool = True,
                 quant_bits: Optional[int] = None) -> GenerationResult:
        """Prefill + masked greedy decode of one batch.

        ``n_tokens`` caps each request's output; ``quant_bits`` serves this
        batch at an explicit precision (``None``: the engine default).
        One host->device and one device->host copy per call; on CUDA the
        decode steps run as the engine's device loop."""
        params, host, caps, nb, bits = self._prepare(prompts, n_tokens,
                                                     quant_bits)
        trace.count("rows", nb)
        with trace.device("dev.prefill", self.device):
            dev = host.to(self.device)                # the one H2D copy
            tokens, caps_d = dev[:, :self.s_max], dev[:, self.s_max]
            if self._gen is None:
                cur, cache = self._prefill(params, tokens)
                self._gen = DecodeState(cache=cache, caps_host=caps,
                                        **self._emission(cur, caps_d))
            else:
                cur, _ = self._prefill(params, tokens, out=self._gen.cache)
            state = self._generate_state(bits, cur, caps_d)
        self._advance(state, min(self.n_max, int(caps.max(initial=0))))
        res = self._read_back(state, [state.out, state.lengths[:, None]])
        return GenerationResult(tokens=res[:nb, :-1], lengths=res[:nb, -1],
                                batch=nb)

    @torch.no_grad()
    def generate_reference(self, prompts: Sequence[Sequence[int]],
                           n_tokens: Optional[Sequence[int]] = None,
                           greedy: bool = True,
                           quant_bits: Optional[int] = None
                           ) -> GenerationResult:
        """The host-driven decode loop: one device->host copy PER TOKEN.
        ``generate`` must match it bit for bit."""
        params, host, caps, nb, _ = self._prepare(prompts, n_tokens,
                                                  quant_bits)
        B = self.batch_capacity
        tokens = host[:, :self.s_max].to(self.device)
        cur_d, cache = self._prefill(params, tokens)
        cur = cur_d.cpu().numpy().astype(np.int32)

        out = np.zeros((B, self.n_max), np.int32)
        lengths = np.zeros((B,), np.int32)
        done = np.zeros((B,), bool)
        for t in range(int(caps.max(initial=0))):
            alive = (~done) & (t < caps)
            if not alive.any():
                break
            out[alive, t] = cur[alive]
            lengths[alive] += 1
            done |= (cur == self.eos_id) & alive
            step_tok = torch.from_numpy(cur).to(self.device)
            cur_d, cache = self._decode(params, cache, step_tok, t)
            cur = cur_d.cpu().numpy().astype(np.int32)
        return GenerationResult(tokens=out[:nb], lengths=lengths[:nb],
                                batch=nb)

    # -- chunked (re-entrant) decode: the continuous-batching data plane ----

    @property
    def paged_capable(self) -> bool:
        """Whether this engine can serve through a paged KV arena: a
        slot-cache layout with no rolling sliding window and a paged decode
        step (MoE is excluded: capacity dispatch couples rows)."""
        return self.model.decode_step_paged is not None \
            and not self.cfg.sliding_window and not self.cfg.is_moe

    def pages_for_admission(self, t: int, n: int,
                            block_tokens: int) -> int:
        """Pages one row admitted at cohort step ``t`` with output cap
        ``n`` will lease over its whole life (cap-aware): its prompt-prefix
        blocks plus the blocks covering its write span ``[s_max + t,
        s_max + min(t + n, n_max))``.  The fully-dead junk-gap blocks map
        to the zero page and cost nothing; blocks past the cap's last write
        block are never leased (overflow writes go to the trash page)."""
        nb = self.cache_len // block_tokens
        t = max(0, int(t))
        end = min(t + int(n), self.n_max)
        if end <= t:
            return 0            # no headroom / cap 0: nothing to lease
        npb = -(-self.s_max // block_tokens)
        b_w = min((self.s_max + t) // block_tokens, nb - 1)
        b_last = (self.s_max + end - 1) // block_tokens
        return npb + max(0, b_last + 1 - max(npb, b_w))

    def _lease_row(self, arena: KVArena, t: int, cap: int):
        """Initial cap-aware lease plan for one row admitted at cohort step
        ``t`` with output cap ``cap``: the blocks to lease now (prompt
        prefix + the first write block, scattered from the prefill cache so
        the gap-tail positions inside it read as the slab's zeros), the
        table row (ZERO for the fully-dead junk gap, TRASH past the lease
        span), and ``(lease_end, lease_last)``."""
        bt = arena.block_tokens
        nb = self.cache_len // bt
        npb = -(-self.s_max // bt)
        b_w = min((self.s_max + int(t)) // bt, nb - 1)
        row = np.full((nb,), TRASH_PAGE, np.int32)
        row[npb:b_w] = ZERO_PAGE        # junk gap [s_max, s_max + t)
        blocks = list(range(npb))
        if b_w >= npb:
            blocks.append(b_w)
        lease_end = b_w + 1 if b_w >= npb else npb
        end = min(int(t) + int(cap), self.n_max)
        b_last = (self.s_max + end - 1) // bt if end > int(t) else 0
        lease_last = max(lease_end, b_last + 1)
        return blocks, row, lease_end, lease_last

    def _extend_leases(self, state: PagedDecodeState, k: int) -> None:
        """Segment-boundary lease top-up: before a segment of at most ``k``
        steps launches, every row's lease must cover the blocks the segment
        can write (a block is read once the cursor passes it, so it is
        leased before the cursor enters it).  Host-side table remap; the
        table re-ships once, lazily, in place, and never inside a segment.
        The cover starts from ``state.t``, the host's upper bound on the
        device step (a segment may exit early), as the JAX package's
        ``t_host``: it can only overshoot, within ``lease_last``."""
        arena = state.arena
        bt = arena.block_tokens
        nb = self.cache_len // bt
        cover = min(state.t + int(k), self.n_max)
        need_end = min((self.s_max + cover - 1) // bt + 1, nb)
        for b in range(state.lease_end.shape[0]):
            tgt = min(need_end, int(state.lease_last[b]))
            le = int(state.lease_end[b])
            if tgt > le:
                state.table.extend_row(b, le, arena.alloc(tgt - le))
                state.lease_end[b] = tgt
                self.lease_topups += tgt - le

    def lease_commitment(self, state: Optional[PagedDecodeState]) -> int:
        """Pages a live cohort is still entitled to lease through future
        top-ups (sum of ``lease_last - lease_end``)."""
        if state is None or state.lease_end is None:
            return 0
        return int(np.maximum(0, state.lease_last.astype(np.int64)
                              - state.lease_end).sum())

    def _forced_buffers(self, prefixes, slots=None):
        """Host (B, n_max) forced-replay token buffer + (B,) lengths from
        per-row resume prefixes (``None`` entries = no replay).  ``slots``
        maps prefix i to its row (defaults to ``0..len-1``)."""
        B = self.batch_capacity
        forced = np.zeros((B, self.n_max), np.int32)
        nf = np.zeros((B,), np.int32)
        if prefixes is not None:
            rows = range(len(prefixes)) if slots is None else slots
            for row, pre in zip(rows, prefixes):
                if pre is not None and len(pre):
                    pre = list(pre)[:self.n_max]
                    forced[row, :len(pre)] = pre
                    nf[row] = len(pre)
        return forced, nf

    def _ship(self, *cols: np.ndarray):
        """One host->device copy of the int32 column blocks ``cols`` (each
        (B,) or (B, c)); returns the (B, c) device view of each block."""
        blocks = [np.asarray(c, np.int32).reshape(self.batch_capacity, -1)
                  for c in cols]
        dev = torch.from_numpy(np.concatenate(blocks, 1)).to(self.device)
        bounds = np.cumsum([0] + [b.shape[1] for b in blocks])
        return [dev[:, a:b] for a, b in zip(bounds[:-1], bounds[1:])]

    def _page_scatter(self, pages, cache, ids: torch.Tensor) -> None:
        """Splice a contiguous prefill cache into the arena, block-wise, in
        place.  ``ids`` (B * n_blocks,) holds the physical page receiving
        logical block (b, j): ``TRASH_PAGE`` for blocks not (re)filled, so
        several blocks land in the trash page at once and which one wins
        is unspecified on CUDA; no live row reads it.  Only the leading
        (nkv, dh) corner of a wider page tail is written."""
        idx = ids.long()
        for name, pleaf in pages.items():
            for l, layer in enumerate(cache):
                c = layer[name]
                B, W = c.shape[:2]
                bt = pleaf.shape[2]
                vals = c.reshape((B * (W // bt), bt) + tuple(c.shape[2:]))
                corner = (idx, slice(None)) + tuple(slice(0, d)
                                                    for d in vals.shape[2:])
                pleaf[l][corner] = vals.to(pleaf.dtype)

    @trace.traced("engine.start_chunked")
    def start_chunked(self, prompts: Sequence[Sequence[int]],
                      n_tokens: Optional[Sequence[int]] = None,
                      quant_bits: Optional[int] = None,
                      arena: Optional[KVArena] = None,
                      prefixes: Optional[Sequence] = None):
        """Prefill a new cohort and return its decode state (one
        host->device copy; decoding hasn't started).  Prompts occupy slots
        ``0..len(prompts)-1``; the other slots are empty (cap 0) and
        refillable.  With ``arena=`` the cohort is arena-backed: the
        prefill cache is scattered block-wise into leased pages and a
        :class:`PagedDecodeState` is returned.  ``prefixes`` seeds per-row
        forced-replay tokens (one entry per prompt, ``None`` = fresh row)
        for preemption resume."""
        params, host, caps, _, bits = self._prepare(prompts, n_tokens,
                                                    quant_bits)
        B = self.batch_capacity
        forced, nf = self._forced_buffers(prefixes)
        cols = [host.numpy(), forced, nf]
        if arena is not None:
            if not self.paged_capable:
                raise ValueError(f"{self.cfg.arch_id} cannot serve from a "
                                 f"paged arena")
            bt = arena.block_tokens
            if self.cache_len % bt:
                raise ValueError(f"cache_len {self.cache_len} not divisible "
                                 f"by block_tokens {bt}")
            nb = self.cache_len // bt
            table = BlockTable(B, nb, n_pages=arena.n_pages,
                               device=self.device)
            ids = np.full((B * nb,), TRASH_PAGE, np.int32)
            lease_end = np.zeros((B,), np.int32)
            lease_last = np.zeros((B,), np.int32)
            for b in range(B):
                if caps[b] > 0:
                    # cap-aware lease: prompt blocks + first write block
                    # now; blocks past it stay TRASH until a top-up
                    blocks, row, le, ll = self._lease_row(arena, 0, caps[b])
                    leases = arena.alloc(len(blocks))
                    row[blocks] = leases
                    table.set_row(b, row)
                    ids[b * nb + np.asarray(blocks)] = leases
                    lease_end[b], lease_last[b] = le, ll
            cols.append(ids)
        trace.count("rows", len(prompts))
        with trace.device("dev.prefill", self.device):
            dev = self._ship(*cols)                   # the one H2D copy
            tokens, caps_d = dev[0][:, :self.s_max], dev[0][:, self.s_max]
            cur, cache = self._prefill(params, tokens)
            emit = dict(bits=bits, caps_host=caps,
                        **self._emission(cur, caps_d, dev[1], dev[2][:, 0]))
            if arena is not None:
                self._page_scatter(arena.buffers(), cache,
                                   dev[3].reshape(-1))
        if arena is None:
            return DecodeState(cache=cache, **emit)
        return PagedDecodeState(arena=arena, table=table, lease_end=lease_end,
                                lease_last=lease_last, **emit)

    @torch.no_grad()
    @trace.traced("engine.generate_chunked")
    def generate_chunked(self, state, k: int):
        """Advance a cohort by at most ``k`` decode steps, to at most
        ``n_max`` (no host transfer inside), and return the re-entrant
        state.  The bound is ``t_end = min(t_dev + k, n_max)`` on the
        device, as the JAX package's; on CUDA the device loop stops there
        or where no row can emit, and the CPU's eager loop runs ``min(k,
        n_max)`` steps, which cover every step that can be live (the rest
        are dead and change nothing).  Driven to completion this is
        bit-identical to ``generate`` for any k.  A
        :class:`PagedDecodeState` first tops its leases up to cover the
        segment (one table re-ship if rows changed), then steps through
        ``decode_step_paged`` on the arena's buffers."""
        if isinstance(state, PagedDecodeState):
            self._extend_leases(state, k)
            state.table.ship()        # rows that changed, before the launch
        torch.clamp(state.t_dev + int(k), max=self.n_max, out=state.t_end)
        self._advance(state, min(int(k), self.n_max))
        return dataclasses.replace(state,
                                   t=min(state.t + int(k), self.n_max))

    def release_slots(self, state: PagedDecodeState,
                      slots: Sequence[int]) -> PagedDecodeState:
        """Return completed rows' page leases to the arena and remap their
        table rows to the trash page; the row's remaining lease entitlement
        is cancelled too."""
        for slot in slots:
            state.arena.free(state.table.row_leases(slot))
            state.table.clear_row(slot)
            if state.lease_end is not None:
                state.lease_end[slot] = 0
                state.lease_last[slot] = 0
        return state

    def release_all(self, state: PagedDecodeState) -> PagedDecodeState:
        """Release every leased page of a drained cohort."""
        return self.release_slots(state,
                                  range(state.table.host.shape[0]))

    @trace.traced("engine.poll_chunked")
    def poll_chunked(self, state, with_tokens: bool = True):
        """Read a cohort's progress back to the host: one device->host copy,
        returning ``(out, lengths, done, t)`` as numpy + int, where ``t`` is
        the cohort's device step ``t_dev`` (the JAX package's ``t``: it
        stops where every row stopped).  ``with_tokens=False`` skips the
        (B, n_max) token buffer and returns None for ``out``."""
        B = state.lengths.shape[0]
        cols = [state.lengths[:, None], state.done[:, None],
                state.t_dev.reshape(1, 1).expand(B, 1)]
        if with_tokens:
            cols.insert(0, state.out)
        res = self._read_back(state, cols)            # one D2H copy
        out = res[:, :-3] if with_tokens else None
        return out, res[:, -3], res[:, -2].astype(bool), int(res[0, -1])

    def exhausted(self, lengths, done, caps_host, t) -> bool:
        """True when no row of a polled cohort can emit again."""
        return t >= self.n_max or \
            not bool(np.any(~done & (lengths < caps_host)))

    def headroom(self, t: int) -> int:
        """Output tokens a row admitted at cohort step ``t`` can still emit
        before the shared cache position hits capacity."""
        return max(0, self.n_max - t)

    def evict_slots(self, state, slots: Sequence[int]):
        """Preempt resident rows at a segment boundary: flag them done and
        zero their caps (one host->device copy of the mask), so the next
        segment treats them like finished rows.  Paged rows also return
        their page leases.  The caller polls any progress it wants to keep
        before evicting."""
        slots = list(slots)
        if not slots:
            return state
        mask = np.zeros((self.batch_capacity,), bool)
        mask[slots] = True
        mask_d = torch.from_numpy(mask).to(self.device)
        state.done |= mask_d
        state.caps.masked_fill_(mask_d, 0)
        caps_host = np.where(mask, 0, state.caps_host)
        if isinstance(state, PagedDecodeState):
            self.release_slots(state, slots)
        return dataclasses.replace(state, caps_host=caps_host)

    @torch.no_grad()
    @trace.traced("engine.refill_chunked")
    def refill_chunked(self, state, slots: Sequence[int],
                       prompts: Sequence[Sequence[int]],
                       n_tokens: Sequence[int], t_now: int,
                       cap_max: Optional[int] = None,
                       prefixes: Optional[Sequence] = None):
        """Prefill new prompts into freed slots of a live cohort.

        The new prompts are padded into their slot rows and prefilled as
        one full-capacity batch (one host->device copy, one prefill), then
        spliced in so live rows keep decoding untouched.  A refilled row's
        cap is clamped to ``headroom(t_now)`` (and to ``cap_max`` when
        given); when the clamp bottoms out at 0, or ``slots`` is empty, the
        refill is a no-op returning ``state`` untouched.  Cache slots
        between a refilled row's prompt and the cohort's position hold zero
        K/V, like the padded prompts.  For a :class:`PagedDecodeState` the
        splice is block-wise and cap-aware: pages are leased for the prompt
        blocks and the first write block, the fully-dead junk gap maps to
        the zero page, and the rest stays TRASH until a top-up."""
        B = self.batch_capacity
        params = self.params_for(state.bits)
        cap_lim = min(self.n_max, self.headroom(t_now))
        if cap_max is not None:
            cap_lim = min(cap_lim, max(0, int(cap_max)))
        if not slots or cap_lim <= 0:
            return state
        toks = np.zeros((B, self.s_max), np.int32)
        new_caps = np.zeros((B,), np.int32)
        refill = np.zeros((B,), bool)
        for slot, p, n in zip(slots, prompts, n_tokens):
            p = list(p)[-self.s_max:]
            if p:
                toks[slot, -len(p):] = p
            new_caps[slot] = min(int(n), cap_lim)
            refill[slot] = True
        forced, nf = self._forced_buffers(prefixes, slots=slots)
        cols = [toks, new_caps, refill, forced, nf]
        paged = isinstance(state, PagedDecodeState)
        if paged:
            arena = state.arena
            nb = self.cache_len // arena.block_tokens
            ids = np.full((B * nb,), TRASH_PAGE, np.int32)
            for slot in slots:
                arena.free(state.table.row_leases(slot))  # stale leases
                blocks, row, le, ll = self._lease_row(
                    arena, t_now, new_caps[slot])
                leases = arena.alloc(len(blocks))
                row[blocks] = leases
                state.table.set_row(slot, row)
                ids[slot * nb + np.asarray(blocks)] = leases
                state.lease_end[slot] = le
                state.lease_last[slot] = ll
            cols.append(ids)
        trace.count("rows", len(slots))
        with trace.device("dev.prefill", self.device):
            dev = self._ship(*cols)                   # the one H2D copy
            caps_d, m = dev[1][:, 0], dev[2][:, 0].bool()
            new_cur, new_cache = self._prefill(params, dev[0])
            # splice in place: refilled rows take their prefill, their caps
            # and their resume prefix (or none); live rows keep theirs
            torch.where(m, new_cur, state.cur, out=state.cur)
            state.out.masked_fill_(m[:, None], 0)
            state.lengths.masked_fill_(m, 0)
            state.done &= ~m
            torch.where(m, caps_d, state.caps, out=state.caps)
            torch.where(m[:, None], dev[3], state.forced, out=state.forced)
            torch.where(m, dev[4][:, 0], state.n_forced, out=state.n_forced)
            if paged:
                self._page_scatter(arena.buffers(), new_cache,
                                   dev[5].reshape(-1))
            else:
                for old, new in zip(state.cache, new_cache):
                    for name in old:
                        mb = m.reshape((-1,) + (1,) * (old[name].dim() - 1))
                        torch.where(mb, new[name], old[name], out=old[name])
        return dataclasses.replace(
            state, caps_host=np.where(refill, new_caps, state.caps_host),
            t=int(t_now))

    def generate_via_chunks(self, prompts: Sequence[Sequence[int]],
                            n_tokens: Optional[Sequence[int]] = None,
                            k: Optional[int] = None,
                            quant_bits: Optional[int] = None,
                            arena: Optional[KVArena] = None
                            ) -> GenerationResult:
        """Drive ``start_chunked`` + ``generate_chunked`` segments to
        completion (one poll per segment): the equivalence harness against
        ``generate``.  With ``arena=`` the cohort runs arena-backed and its
        pages are released on completion."""
        k = self.n_max if k is None else k
        state = self.start_chunked(prompts, n_tokens, quant_bits,
                                   arena=arena)
        while True:
            state = self.generate_chunked(state, k)
            out, lengths, done, t = self.poll_chunked(state)
            if self.exhausted(lengths, done, state.caps_host, t):
                break
        if arena is not None:
            self.release_all(state)
        nb = len(prompts)
        return GenerationResult(tokens=out[:nb], lengths=lengths[:nb],
                                batch=nb)
