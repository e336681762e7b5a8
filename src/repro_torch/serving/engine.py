"""Batched-inference engine (port of ``repro.serving.engine``): executes
scheduled batches on the PyTorch model.

A scheduled batch of prompts is padded to the epoch's s' (the paper's
'extend all prompts to the maximum length' assumption), prefilled in one
pass, then decoded greedily with sampling, EOS detection and per-request
output caps all on the device.  Per ``generate`` call there is exactly ONE
host->device copy (prompts and caps, in one tensor) and ONE device->host
copy (tokens and lengths, in one tensor).

Eager PyTorch has no device-side ``while_loop``, so the host runs the loop
for ``min(n_max, max(caps))`` steps (a number it already knows) and masks
every row on the device; it never reads a device value inside the loop.
The JAX package's loop exits once no row can emit; the rows this loop
keeps stepping after that never emit again, so the tokens are the same.
``generate_reference`` is the host-driven loop with one device->host copy
per token, kept as the oracle ``generate`` must equal bit for bit.

The same loop exists in re-entrant form for continuous batching:
``start_chunked`` prefills a cohort into a ``DecodeState`` (or, with
``arena=``, a ``PagedDecodeState`` whose KV lives in a node-wide
``KVArena``), ``generate_chunked(state, k)`` advances it by at most k
tokens, ``poll_chunked`` reads its progress back, and ``refill_chunked``
prefills new prompts into slots freed by finished rows of the live cohort.
Host copies: one host->device copy per ``start_chunked`` /
``refill_chunked`` (prompts, caps, refill mask, forced-replay buffers and
page-scatter ids in one tensor), one device->host copy per
``poll_chunked``, a block-table re-ship only at a boundary where table rows
changed, and none inside a segment.

The device-side early exit: the JAX package's segment is a device
``while_loop`` that also stops as soon as no row is alive, so its step
``t`` can stop short of ``t_end``.  Here a segment always runs
``min(t + k, n_max) - t`` masked steps, a count the host knows, and the
step ``t`` is a host int.  The two differ only after a segment in which
every row finished, and such a cohort is never stepped again: the
continuous executor drains and resets the pool when no resident row is
left, and ``generate_via_chunks`` stops when ``exhausted``.  So every
``t`` that feeds ``headroom`` or an admission equals the JAX package's
(``tests/test_torch_continuous.py`` holds the runtime's counts to it).

Weights can be served quantized: ``quant_bits`` picks the default
precision and ``generate(..., quant_bits=...)`` serves one batch at the
precision the scheduler decided.  Each precision is quantized once from
the full-precision weights and cached (``params_for``).  A precision is an
int (weight bits) or a ``(weight_bits, act_bits)`` pair; ``(8, 8)`` is
W8A8.  Quantized trees keep their QTensor leaves on every device: on a
CUDA device they run through the hand-written kernels, on the CPU through
the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import ModelConfig, get_arch
from repro_torch.kernels import ops as kops
from repro_torch.models.api import Model, build_model
from repro_torch.quant.ptq import QTensor, quantize_tree, with_act_bits
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
    the tensors live on the engine's device, so re-entering costs no
    transfer.  A state passed to ``generate_chunked``, ``refill_chunked``
    or ``evict_slots`` is CONSUMED (its tensors may be updated in place):
    always continue from the returned state.

    ``t`` is the cohort's decode step, a host int: the shared KV-cache
    write position is ``s_max + t``, bounded by ``n_max``.  Rows track
    their own emission through ``lengths``, so rows admitted mid-cohort
    emit into their row of ``out`` from 0 whatever ``t`` is.  While
    ``lengths[i] < n_forced[i]`` a row emits ``forced[i, lengths[i]]``
    instead of its argmax: the preemption-resume replay that keeps an
    already-delivered prefix exact (all zero outside resume).
    """
    cache: Any                  # per-layer KV slot caches, full batch capacity
    cur: torch.Tensor           # (B,) next token to emit per row
    out: torch.Tensor           # (B, n_max) emitted tokens per row
    lengths: torch.Tensor       # (B,) emitted count per row
    done: torch.Tensor          # (B,) bool, EOS seen
    caps: torch.Tensor          # (B,) per-row output cap (0 = empty slot)
    t: int = 0                  # cohort decode step
    bits: Any = 0               # precision spec (int or (w, a) pair)
    caps_host: np.ndarray = None  # host mirror of caps
    forced: torch.Tensor = None   # (B, n_max) forced-replay tokens
    n_forced: torch.Tensor = None  # (B,) forced-prefix length per row

    @property
    def batch_capacity(self) -> int:
        return int(self.caps_host.shape[0])


@dataclass
class PagedDecodeState:
    """Arena-backed sibling of :class:`DecodeState`: the cohort's KV lives
    in its node-wide :class:`KVArena`, and the state holds the cohort's
    :class:`BlockTable` and the same per-row emission fields.  Rows lease
    pages at admission and return them through ``release_slots`` the
    moment they complete.  Cap-aware incremental leasing: per row,
    ``lease_end`` is one past the highest block leased and ``lease_last``
    one past the last block its cap can ever need; blocks in
    ``[lease_end, lease_last)`` are TRASH in the table until a
    segment-boundary top-up (``_extend_leases``) leases them."""
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
        # decode attention through flash_decode; the plain masked softmax
        # (use_kernel=False) serves the CPU only
        if not use_kernel and self.device.type == "cuda":
            raise ValueError("use_kernel=False runs on the CPU only; on "
                             "CUDA decode attention is the flash_decode "
                             "kernel")
        self.use_kernel = bool(use_kernel)
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
        epoch."""
        bits = self._canon_bits(bits)
        if bits not in self._params_cache:
            if bits == 0:
                p = self._raw_params
            elif isinstance(bits, int):
                p = quantize_tree(self._raw_params, bits)
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
        """The decode-attention tier ``use_kernel=True`` serving at
        ``bits`` (engine default when None) routes to: ``"fused"`` (K6/K7)
        or ``"flash"`` (K4/K5), see ``kernels.ops.decode_kernel_tier``."""
        params = self.params_for(self.default_bits if bits is None
                                 else bits)
        return kops.decode_kernel_tier(params["layers"][0]["attn"], self.cfg)

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
        host caps, batch size)."""
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
        return params, torch.from_numpy(host), caps, nb

    def _prefill(self, params, tokens):
        """Prompt pass; returns (first sampled token (B,), KV cache)."""
        logits, cache = self.model.prefill(params, {"tokens": tokens},
                                           self.cache_len)
        return torch.argmax(logits[..., :self.cfg.vocab], -1), cache

    def _decode(self, params, cache, cur, t):
        logits, cache = self.model.decode_step(
            params, cache, cur[:, None], self.s_max + t,
            use_kernel=self.use_kernel)
        return torch.argmax(logits[..., :self.cfg.vocab], -1), cache

    @torch.no_grad()
    def generate(self, prompts: Sequence[Sequence[int]],
                 n_tokens: Optional[Sequence[int]] = None,
                 greedy: bool = True,
                 quant_bits: Optional[int] = None) -> GenerationResult:
        """Prefill + masked greedy decode of one batch.

        ``n_tokens`` caps each request's output; ``quant_bits`` serves this
        batch at an explicit precision (``None``: the engine default).
        One host->device and one device->host copy per call."""
        params, host, caps, nb = self._prepare(prompts, n_tokens, quant_bits)
        B = self.batch_capacity
        dev = host.to(self.device)                    # the one H2D copy
        tokens, caps_d = dev[:, :self.s_max], dev[:, self.s_max]
        cur, cache = self._prefill(params, tokens)
        out = torch.zeros((B, self.n_max), dtype=cur.dtype, device=self.device)
        lengths = torch.zeros((B,), dtype=cur.dtype, device=self.device)
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        for t in range(min(self.n_max, int(caps.max(initial=0)))):
            alive = (~done) & (caps_d > t)
            out[:, t] = torch.where(alive, cur, out[:, t])
            lengths += alive
            done |= (cur == self.eos_id) & alive
            cur, cache = self._decode(params, cache, cur, t)
        res = torch.cat([out, lengths[:, None]], 1).cpu().numpy()  # one D2H
        res = res.astype(np.int32)
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
        params, host, caps, nb = self._prepare(prompts, n_tokens, quant_bits)
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
        table re-ships once, lazily, and never inside a segment.  The
        cohort step ``t`` is host-known here, so the cover is exact (the
        JAX package bounds it from a host-side estimate)."""
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
        params, host, caps, _ = self._prepare(prompts, n_tokens, quant_bits)
        bits = self.default_bits if quant_bits is None \
            else self._canon_bits(quant_bits)
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
        dev = self._ship(*cols)                       # the one H2D copy
        tokens, caps_d = dev[0][:, :self.s_max], dev[0][:, self.s_max]
        cur, cache = self._prefill(params, tokens)
        emit = dict(cur=cur,
                    out=torch.zeros((B, self.n_max), dtype=cur.dtype,
                                    device=self.device),
                    lengths=torch.zeros((B,), dtype=cur.dtype,
                                        device=self.device),
                    done=torch.zeros((B,), dtype=torch.bool,
                                     device=self.device),
                    caps=caps_d, t=0, bits=bits, caps_host=caps,
                    forced=dev[1], n_forced=dev[2][:, 0])
        if arena is None:
            return DecodeState(cache=cache, **emit)
        self._page_scatter(arena.buffers(), cache, dev[3].reshape(-1))
        return PagedDecodeState(arena=arena, table=table, lease_end=lease_end,
                                lease_last=lease_last, **emit)

    def _segment(self, step, state, t_end: int):
        """``t_end - state.t`` masked decode steps (no host transfer);
        ``step(tokens, pos)`` runs the model.  Per step: a row emits at its
        own ``lengths[i]`` (its forced token while replaying), EOS and caps
        retire it, and every row steps the model."""
        cur, out, lengths, done = state.cur, state.out, state.lengths, \
            state.done
        caps, forced, n_forced = state.caps, state.forced, state.n_forced
        for t in range(state.t, t_end):
            alive = (~done) & (lengths < caps)
            idx = torch.clamp(lengths, max=self.n_max - 1)[:, None]
            cur = torch.where(lengths < n_forced,
                              torch.gather(forced, 1, idx)[:, 0].to(cur.dtype),
                              cur)
            out.scatter_(1, idx, torch.where(
                alive, cur, torch.gather(out, 1, idx)[:, 0])[:, None])
            lengths = lengths + alive
            done = done | ((cur == self.eos_id) & alive)
            cur = step(cur[:, None], self.s_max + t)
        return dataclasses.replace(state, cur=cur, out=out, lengths=lengths,
                                   done=done, t=t_end)

    @torch.no_grad()
    def generate_chunked(self, state, k: int):
        """Advance a cohort by ``min(t + k, n_max) - t`` decode steps (no
        host transfer inside) and return the re-entrant state.  Driven to
        completion this is bit-identical to ``generate`` for any k.  A
        :class:`PagedDecodeState` first tops its leases up to cover the
        segment (one table re-ship if rows changed), then steps through
        ``decode_step_paged`` on the arena's buffers."""
        params = self.params_for(state.bits)
        t_end = min(state.t + int(k), self.n_max)
        kw = dict(use_kernel=self.use_kernel)
        if isinstance(state, PagedDecodeState):
            self._extend_leases(state, k)
            pages, table = state.arena.buffers(), state.table.device

            def step(tokens, pos):
                logits, _ = self.model.decode_step_paged(
                    params, pages, table, tokens, pos, **kw)
                return torch.argmax(logits[..., :self.cfg.vocab], -1)
        else:
            def step(tokens, pos):
                logits, _ = self.model.decode_step(params, state.cache,
                                                   tokens, pos, **kw)
                return torch.argmax(logits[..., :self.cfg.vocab], -1)
        return self._segment(step, state, t_end)

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

    def poll_chunked(self, state, with_tokens: bool = True):
        """Read a cohort's progress back to the host: one device->host copy,
        returning ``(out, lengths, done, t)`` as numpy + int.
        ``with_tokens=False`` skips the (B, n_max) token buffer and returns
        None for ``out``."""
        cols = [state.lengths[:, None], state.done[:, None].to(
            state.lengths.dtype)]
        if with_tokens:
            cols.insert(0, state.out)
        res = torch.cat(cols, 1).cpu().numpy().astype(np.int32)  # one D2H
        out = res[:, :-2] if with_tokens else None
        return out, res[:, -2], res[:, -1].astype(bool), int(state.t)

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
        done = state.done | mask_d
        caps = torch.where(mask_d, torch.zeros_like(state.caps), state.caps)
        caps_host = np.where(mask, 0, state.caps_host)
        if isinstance(state, PagedDecodeState):
            self.release_slots(state, slots)
        return dataclasses.replace(state, done=done, caps=caps,
                                   caps_host=caps_host)

    @torch.no_grad()
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
        dev = self._ship(*cols)                       # the one H2D copy
        caps_d, m = dev[1][:, 0], dev[2][:, 0].bool()
        new_cur, new_cache = self._prefill(params, dev[0])
        # forced-replay splice (preemption resume): refilled rows take
        # their resume prefix (or none); live rows keep theirs
        emit = dict(
            cur=torch.where(m, new_cur, state.cur),
            out=torch.where(m[:, None], torch.zeros_like(state.out),
                            state.out),
            lengths=torch.where(m, torch.zeros_like(state.lengths),
                                state.lengths),
            done=state.done & ~m,
            caps=torch.where(m, caps_d, state.caps),
            caps_host=np.where(refill, new_caps, state.caps_host),
            forced=torch.where(m[:, None], dev[3], state.forced),
            n_forced=torch.where(m, dev[4][:, 0], state.n_forced))
        if paged:
            self._page_scatter(arena.buffers(), new_cache,
                               dev[5].reshape(-1))
            return dataclasses.replace(state, **emit)
        for old, new in zip(state.cache, new_cache):
            for name in old:
                mb = m.reshape((-1,) + (1,) * (old[name].dim() - 1))
                torch.where(mb, new[name], old[name], out=old[name])
        return dataclasses.replace(state, **emit)

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
