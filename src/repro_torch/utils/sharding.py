"""Sharding helpers (port of ``repro.utils.sharding``).

Models are written against *logical* axes (``batch``, ``model``) and only
apply a sharding constraint when a launcher has installed an axis
context.  Single-device runs never install one, so the same model code runs
unconstrained, and a hint then dispatches no op at all: it returns its
input, which is what a captured decode step needs.

Constraints are divisibility-aware: if a tensor dim is not divisible by the
mesh axes mapped to it (e.g. 56 attention heads over a 16-way model axis),
that dim falls back to replicated.

A spec (the counterpart of ``jax.sharding.PartitionSpec``) is a ``P``: a
tuple with one entry per tensor dim, each ``None`` (replicated), a mesh
axis name, or a tuple of names (sharded over their product, major first).
``placements`` turns it into DTensor placements for a ``DeviceMesh``, and
``constrain`` on a DTensor redistributes it to them, the counterpart of
``with_sharding_constraint``.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

_state = threading.local()


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, a mesh axis
    name or a tuple of them)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _ctx() -> Optional["AxisCtx"]:
    return getattr(_state, "ctx", None)


class AxisCtx:
    """Maps logical axis names to physical mesh axis names.

    ``batch`` -> tuple of mesh axes the batch dim is sharded over
    (("data",) single-pod, ("pod", "data") multi-pod, or () replicated);
    ``model`` -> the tensor-parallel mesh axis (or None).
    ``sizes`` -> physical mesh axis sizes, used for divisibility checks.
    ``mesh`` -> the ``DeviceMesh`` that ``constrain`` redistributes over
    (None: specs resolve, nothing is redistributed).
    """

    def __init__(self, batch: Sequence[str] = ("data",),
                 model: Optional[str] = "model",
                 sizes: Optional[Dict[str, int]] = None, mesh=None):
        self.batch: Tuple[str, ...] = tuple(batch)
        self.model = model
        self.sizes = dict(sizes or {})
        self.mesh = mesh

    def resolve(self, name: Optional[str]):
        if name is None:
            return None
        if name == "batch":
            return self.batch if self.batch else None
        if name == "model":
            return self.model
        raise ValueError(f"unknown logical axis {name!r}")

    def divisor(self, name: Optional[str]) -> int:
        axes = self.resolve(name)
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.sizes.get(a, 1) for a in axes)


@contextlib.contextmanager
def axis_ctx(batch: Sequence[str] = ("data",), model: Optional[str] = "model",
             sizes: Optional[Dict[str, int]] = None, mesh=None):
    prev = _ctx()
    _state.ctx = AxisCtx(batch, model, sizes, mesh)
    try:
        yield _state.ctx
    finally:
        _state.ctx = prev


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_ctx_for_mesh(mesh, batch: Sequence[str] = ("data",),
                      model: Optional[str] = "model"):
    sizes = mesh_sizes(mesh)
    batch = tuple(a for a in batch if a in sizes)
    model = model if (model in sizes) else None
    return axis_ctx(batch, model, sizes, mesh)


def logical_spec(*names: Optional[str],
                 shape: Optional[Tuple[int, ...]] = None) -> Optional[P]:
    """Resolve logical dim names to a spec under the active context.

    Returns None when no context is installed (=> no constraint applied).
    When ``shape`` is given, dims not divisible by their mapped mesh axes
    fall back to replicated.
    """
    ctx = _ctx()
    if ctx is None:
        return None
    entries = []
    for i, n in enumerate(names):
        if shape is not None and n is not None:
            if shape[i] % ctx.divisor(n) != 0:
                entries.append(None)
                continue
        entries.append(ctx.resolve(n))
    return P(*entries)


def placements(spec: Sequence, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(i)`` where tensor dim i's entry names it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.mesh_dim_names:
        dim = None
        for i, entry in enumerate(spec):
            names = (entry,) if isinstance(entry, str) else (entry or ())
            if axis in names:
                dim = i
        out.append(Shard(dim) if dim is not None else Replicate())
    return out


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to logical dim names (``x`` itself, with no
    op dispatched, without an installed axis context, a mesh in it, or a
    DTensor ``x``; non-divisible dims fall back to replicated)."""
    ctx = _ctx()
    if ctx is None or ctx.mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = logical_spec(*names, shape=tuple(x.shape))
    want = placements(spec, ctx.mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(ctx.mesh, want)


def active() -> bool:
    return _ctx() is not None


def axis_divisor(name: str) -> int:
    """Product of mesh-axis sizes behind a logical axis (1 if no context)."""
    ctx = _ctx()
    return 1 if ctx is None else ctx.divisor(name)


def on_mesh(x: torch.Tensor) -> bool:
    """Whether ``x`` is a DTensor under an installed mesh context."""
    ctx = _ctx()
    if ctx is None or ctx.mesh is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def sharded_dim(x: torch.Tensor, name: str) -> Optional[int]:
    """The dim of DTensor ``x`` sharded over logical axis ``name``'s mesh
    axis (None for a plain tensor, no context, or a replicated axis)."""
    ctx = _ctx()
    if ctx is None or ctx.mesh is None:
        return None
    from torch.distributed.tensor import DTensor, Shard
    axis = ctx.resolve(name)
    if not isinstance(x, DTensor) or not isinstance(axis, str):
        return None
    p = x.placements[list(ctx.mesh.mesh_dim_names).index(axis)]
    return p.dim if isinstance(p, Shard) else None


def seq_gather(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, S, ...) with its sequence dim gathered where it is
    sharded over 'model' (``seq_shard``'s residual after a norm: Megatron
    sequence parallelism's all-gather before the column-parallel matmul);
    ``x`` itself otherwise.  DTensor then never merges a sharded batch dim
    with a sharded sequence dim (a strided shard) when a matmul flattens
    them."""
    if sharded_dim(x, "model") != 1:
        return x
    from torch.distributed.tensor import Replicate
    ctx = _ctx()
    want = list(x.placements)
    want[list(ctx.mesh.mesh_dim_names).index(ctx.model)] = Replicate()
    return x.redistribute(ctx.mesh, want)


def local_elementwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise ``fn`` that DTensor has no sharding
    strategy for (log-sigmoid): on a DTensor it runs on each device's
    shard through ``local_map`` (a partial sum reduced first), which
    leaves the function unchanged; on a plain tensor it is ``fn(x)``."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return fn(x)
    from torch.distributed.tensor.experimental import local_map
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    return local_map(fn, out_placements=pl, in_placements=(pl,),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x)


def head_local(fn, args, head_dims, shard_heads: bool, batched=None,
               out_head_dims=(2,)):
    """``fn(*args)`` (attention, the SSD scan) run on each device's shard
    of the batch (dim 0 of the args ``batched`` marks; by default those
    whose dim 0 is the batch) and, with ``shard_heads``, of the heads
    (``head_dims[i]`` of arg i; None: no head dim), through ``local_map``;
    each result (batch first, its heads at ``out_head_dims``) comes back
    sharded the same way.  Inside, the step runs on local tensors, so
    DTensor never merges a sharded batch dim with a sharded head dim (a
    strided shard).  Without a mesh context or a DTensor among ``args`` it
    is ``fn(*args)``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    ctx = _ctx()
    if ctx is None or ctx.mesh is None or not any(
            isinstance(a, DTensor) for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    mesh = ctx.mesh
    B = args[0].shape[0]
    batch_ok = B > 1 and B % ctx.divisor("batch") == 0

    def pl(batch: bool, head: Optional[int]):
        out = []
        for axis in mesh.mesh_dim_names:
            if batch and axis in ctx.batch:
                out.append(Shard(0))
            elif shard_heads and head is not None and axis == ctx.model:
                out.append(Shard(head))
            else:
                out.append(Replicate())
        return out

    if batched is None:
        batched = [a is not None and a.shape[0] == B for a in args]
    ins, placed = [], []
    for a, hd, bt in zip(args, head_dims, batched):
        if a is None:
            ins.append(None)
            placed.append(None)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        ins.append(pl(batch_ok and bt, hd))
        placed.append(a)
    # the distinct shards the work splits into (a flop counter scales the
    # local ops it sees inside, and their backward, by it: ``local_shards``)
    shards = (ctx.divisor("batch") if batch_ok else 1) \
        * (ctx.divisor("model") if shard_heads else 1)

    def local(*xs):
        out = fn(*xs)
        for o in (out if isinstance(out, tuple) else (out,)):
            _tag_backward(o, xs, shards)
        return out

    prev = getattr(_state, "local_shards", 1)
    _state.local_shards = shards
    try:
        outs = [pl(batch_ok, hd) for hd in out_head_dims]
        return local_map(local, out_placements=outs[0] if len(outs) == 1
                         else tuple(outs),
                         in_placements=tuple(ins), device_mesh=mesh,
                         redistribute_inputs=True)(*placed)
    finally:
        _state.local_shards = prev


# id of an autograd node of a head_local region's backward -> (its
# sequence number, shards): the pair names one node (ids are reused)
_REGIONS: Dict[int, Tuple[int, int]] = {}


def _tag_backward(out: torch.Tensor, inputs, shards: int) -> None:
    """Record the autograd nodes between ``inputs`` and ``out`` (a
    ``head_local`` region's backward), each until it has run."""
    if out.grad_fn is None:
        return
    # the region's nodes are the ones made after its inputs' (sequence
    # numbers rise in the order a thread makes nodes)
    first = max((t.grad_fn._sequence_nr() for t in inputs
                 if isinstance(t, torch.Tensor) and t.grad_fn is not None),
                default=-1)
    todo = [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or type(node).__name__ == "AccumulateGrad" \
                or node._sequence_nr() <= first \
                or _REGIONS.get(id(node), (None,))[0] == node._sequence_nr():
            continue
        _REGIONS[id(node)] = (node._sequence_nr(), shards)
        node.register_hook(functools.partial(_untag, id(node)))
        todo.extend(f for f, _ in node.next_functions)


def _untag(key: int, grad_inputs, grad_outputs) -> None:
    _REGIONS.pop(key, None)


def local_shards() -> int:
    """Inside ``head_local``, or in the backward of its ops: into how many
    distinct shards its work is split (the step's work is the local work
    times this); else 1."""
    n = getattr(_state, "local_shards", 1)
    if n == 1 and _REGIONS:
        node = torch._C._current_autograd_node()
        if node is not None:
            seq, shards = _REGIONS.get(id(node), (None, 1))
            if seq == node._sequence_nr():
                n = shards
    return n


def clear_regions() -> None:
    """Forget the recorded ``head_local`` backward nodes (a new trace)."""
    _REGIONS.clear()
