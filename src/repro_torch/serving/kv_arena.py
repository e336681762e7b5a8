"""Node-wide paged KV arena: block-pool allocator + per-row block tables
(port of ``repro.serving.kv_arena``).

One device-resident pool of fixed ``block_tokens``-slot pages per cache
leaf, shaped ``(L, n_pages, block_tokens, nkv', dh')`` (layers stacked on
axis 0 so one page id covers all L layers of a row's block), a LIFO
free-list allocator that leases pages to cohort rows and takes them back
the moment a row completes, and a :class:`BlockTable` per cohort mapping
(row, logical block) to its physical page.  The paged decode kernel
(``kernels.ops.flash_decode_paged``) and its plain version read K/V
through that table.

Two pages are RESERVED and never allocated:

* ``ZERO_PAGE`` -- all-zero and never written.  A row refilled at cohort
  step t has a junk gap ``[s_max, s_max + t)`` that the slab path fills
  with zero K/V; its fully-dead gap blocks map here.  A live row's write
  block is always a real page, so no live row ever writes this page.
* ``TRASH_PAGE`` -- scratch for rows with no lease (empty slots, released
  rows) and for every block past a row's lease span.  Dead rows keep
  stepping through the model, so their writes land here, several rows at
  once: on a CUDA device the winner of such a duplicate-index write is
  unspecified, which is harmless only because no live row ever reads the
  trash page (blocks a row will read are leased before its write cursor
  enters them).

Differences from the JAX package: buffers are torch tensors on the
engines' device, zero-initialized and updated in place by the engine;
``BlockTable.device`` is an int32 tensor on the table's device, shipped
lazily and again, in place, only after a row changed (it keeps its
address, so a captured decode step reads the latest table);
``for_engines`` takes the leaf shapes from the port's own ``init_cache``
on the meta device (its cache is a list of per-layer dicts, so the layer
count becomes axis 0).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

ZERO_PAGE = 0
TRASH_PAGE = 1
N_RESERVED = 2


class ArenaError(RuntimeError):
    """Allocator misuse: double-free, freeing a reserved page, or a page
    id outside the pool.  A real exception (not an assert) so the guards
    survive ``python -O``."""


class ArenaExhausted(ArenaError):
    """alloc() asked for more pages than the free list holds -- admission
    control must gate on ``free_pages`` so this never fires in the
    runtime."""


class BlockTable:
    """Logical-block -> physical-page map for one cohort (B rows x n_b
    logical blocks).  The host array is authoritative; ``device`` is the
    int32 mirror the decode segment reads, on ``device`` (re-shipped only
    when rows changed -- admission/release/top-up boundaries, never inside
    a segment -- by one host->device copy into the same tensor).
    ``n_pages`` (when given) bounds every page id written through
    ``set_row``/``extend_row``."""

    def __init__(self, batch: int, n_blocks: int,
                 n_pages: Optional[int] = None, device="cpu"):
        self.host = np.full((batch, n_blocks), TRASH_PAGE, np.int32)
        self.n_pages = n_pages
        self.on = torch.device(device)
        self._device: Optional[torch.Tensor] = None
        self._stale = True

    @property
    def device(self) -> torch.Tensor:
        return self.ship()

    def ship(self) -> torch.Tensor:
        """The device mirror, re-shipped first if rows changed since the
        last ship (one host->device copy, into the same tensor after the
        first)."""
        if self._stale:
            fresh = torch.from_numpy(self.host.copy()).to(self.on)
            if self._device is None:
                self._device = fresh
            else:
                self._device.copy_(fresh)
            self._stale = False
        return self._device

    def _check(self, pages: np.ndarray) -> None:
        if pages.size and (pages.min() < 0 or (self.n_pages is not None
                                               and pages.max()
                                               >= self.n_pages)):
            raise ArenaError(
                f"page id out of range [0, {self.n_pages}): "
                f"{sorted(set(pages.tolist()))}")

    def set_row(self, slot: int, pages: Sequence[int]) -> None:
        pages = np.asarray(pages, np.int32)
        self._check(pages)
        self.host[slot] = pages
        self._stale = True

    def extend_row(self, slot: int, start: int,
                   pages: Sequence[int]) -> None:
        """Map blocks ``[start, start + len(pages))`` of a live row to
        freshly leased pages (the incremental lease top-up).  Host-side
        remap only; the device mirror re-ships lazily, so any number of
        same-boundary extends cost one transfer."""
        pages = np.asarray(pages, np.int32)
        self._check(pages)
        self.host[slot, start:start + len(pages)] = pages
        self._stale = True

    def clear_row(self, slot: int) -> None:
        """Remap a row entirely to the trash page (dead rows keep
        stepping; their writes become don't-care writes)."""
        self.host[slot] = TRASH_PAGE
        self._stale = True

    def row_leases(self, slot: int) -> List[int]:
        """Real (allocated) pages currently mapped by a row."""
        return [int(p) for p in self.host[slot] if p >= N_RESERVED]


class KVArena:
    """Fixed-size block pool shared by every paged engine on the node.

    ``leaf_specs`` maps each cache leaf to a tensor whose shape and dtype
    describe one batch row of it, layers stacked: ``(L, 1, W, *tail)``
    (meta tensors, as ``for_engines`` builds them)."""

    def __init__(self, leaf_specs: Dict[str, torch.Tensor], n_pages: int,
                 block_tokens: int, device="cpu"):
        if n_pages <= N_RESERVED:
            raise ValueError(f"n_pages {n_pages} leaves no allocatable page")
        self.block_tokens = int(block_tokens)
        self.n_pages = int(n_pages)
        self.leaf_specs = dict(leaf_specs)
        # ZERO_PAGE relies on zero-init: zero K/V == the slab's zero gap
        self._buffers = {
            name: torch.zeros((spec.shape[0], n_pages, block_tokens)
                              + tuple(spec.shape[3:]), dtype=spec.dtype,
                              device=device)
            for name, spec in leaf_specs.items()}
        # LIFO list (pop order: hot pages stay hot) + membership set, so
        # the double-free guard is O(1) and a real check
        self._free: List[int] = list(range(n_pages - 1, N_RESERVED - 1, -1))
        self._free_set = set(self._free)
        self.alloc_peak = 0

    # -- construction --------------------------------------------------------

    @classmethod
    def for_engines(cls, engines, block_tokens: int = 16,
                    shrink: float = 1.0, extra_pages: int = 0) -> "KVArena":
        """Size an arena for the paged-capable engines of a node, on their
        device.

        Page-leaf shapes come from each engine's ``init_cache`` (batch 1,
        on the meta device).  Engines must share leaf names, layer count,
        dtype and device, and have a ``cache_len`` divisible by
        ``block_tokens`` (what makes the gathered paged cache bitwise equal
        to the slab cache).  Trailing dims (nkv, d_head) may differ across
        cohorts: the pool provisions the elementwise max and each engine
        reads and writes only the leading corner of a page's tail."""
        paged = [e for e in _as_list(engines) if e.paged_capable]
        if not paged:
            raise ValueError("no paged-capable engine to size the arena for")
        devices = {e.device for e in paged}
        if len(devices) != 1:
            raise ValueError(f"paged engines must share a device, got "
                             f"{sorted(map(str, devices))}")
        specs: Optional[Dict[str, torch.Tensor]] = None
        slab_pages = 0
        for e in paged:
            if e.cache_len % block_tokens:
                raise ValueError(
                    f"cache_len {e.cache_len} not divisible by "
                    f"block_tokens {block_tokens}")
            layers = e.model.init_cache(1, e.cache_len, "meta")
            s = {name: torch.empty((len(layers),) + tuple(leaf.shape),
                                   dtype=leaf.dtype, device="meta")
                 for name, leaf in layers[0].items()}
            if specs is None:
                specs = s
            else:
                if set(specs) != set(s):
                    raise ValueError("paged engines must share KV leaf names")
                for name, spec in s.items():
                    have = specs[name]
                    if (have.dtype != spec.dtype
                            or have.dim() != spec.dim()
                            or have.shape[0] != spec.shape[0]):
                        raise ValueError(
                            "paged engines must share KV layer count and "
                            f"dtype (leaf {name!r}: {tuple(have.shape)} "
                            f"{have.dtype} vs {tuple(spec.shape)} "
                            f"{spec.dtype})")
                    tail = tuple(max(a, b) for a, b in
                                 zip(have.shape[3:], spec.shape[3:]))
                    specs[name] = torch.empty(tuple(have.shape[:3]) + tail,
                                              dtype=have.dtype, device="meta")
            slab_pages += e.batch_capacity * (e.cache_len // block_tokens)
        n_pages = N_RESERVED + extra_pages \
            + max(1, math.ceil(slab_pages * shrink))
        return cls(specs, n_pages, block_tokens, device=devices.pop())

    # -- allocator -----------------------------------------------------------

    @property
    def total_pages(self) -> int:
        """Allocatable pages (reserved pair excluded)."""
        return self.n_pages - N_RESERVED

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.total_pages - len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Lease ``n`` pages (LIFO -- hot pages stay hot).  Raises
        :class:`ArenaExhausted` if the free list is short."""
        if n > len(self._free):
            raise ArenaExhausted(
                f"need {n} pages, {len(self._free)} free of "
                f"{self.total_pages}")
        pages = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(pages)
        self.alloc_peak = max(self.alloc_peak, self.pages_in_use)
        return pages

    def free(self, pages: Sequence[int]) -> None:
        """Return leased pages.  Raises :class:`ArenaError` on a
        double-free, a reserved page, or an id outside the pool."""
        for p in pages:
            p = int(p)
            if p < N_RESERVED:
                raise ArenaError(f"freeing reserved page {p}")
            if p >= self.n_pages:
                raise ArenaError(
                    f"freeing out-of-range page {p} (pool has "
                    f"{self.n_pages} pages)")
            if p in self._free_set:
                raise ArenaError(f"double free of page {p}")
            self._free.append(p)
            self._free_set.add(p)

    # -- device buffers ------------------------------------------------------

    def buffers(self) -> Dict[str, torch.Tensor]:
        """The page buffers, ``{name: (L, n_pages, block_tokens, *tail)}``;
        the engine writes them in place."""
        return self._buffers


def _as_list(engines):
    if isinstance(engines, dict):
        return list(engines.values())
    if isinstance(engines, (list, tuple)):
        return list(engines)
    return [engines]
