"""Sharded step functions: the bridge between models and meshes (port of
``repro.launch.steps``).

``param_specs`` assigns every parameter leaf a spec (``utils.sharding.P``)
from name-based tensor-parallel rules (Megatron layout adapted per
family); ``batch_specs`` / ``cache_specs`` shard activations and caches.
All rules are divisibility-aware: a dim that doesn't divide its mesh axes
falls back to replicated (e.g. 56 heads on a 16-way model axis).
``shardings`` places a tree onto a ``DeviceMesh`` by its specs, as
DTensors; on a mesh whose axes are all of size 1 it leaves the plain
tensors, so a step there runs exactly as without a mesh.

The JAX package's rules read its stacked leaves, (L, ...) or (G, K, ...);
the port keeps per-layer lists.  Each port leaf's spec is computed on the
stacked shape (the stack axes of ``models.api.STACKED`` put back in front,
as ``train.optimizer.decay_flags`` counts them) and the stack entries are
then dropped.  Where the rule put a mesh axis on a stack dim, the
per-layer leaf stays replicated on that axis (``stack_dim_axes`` lists
those leaves).

Step builders return (fn, args, in_specs, out_specs, donate) with the args
as fake tensors (``FakeTensorMode``, the counterpart of
``jax.ShapeDtypeStruct``: nothing is allocated).  ``trace_step`` places
them and runs the step once under the roofline's counters, where the JAX
package lowers it (``lower_step``): a torch step is run, not lowered.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models.api import STACKED, Model, build_model
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         adamw_init, adamw_update)
from repro_torch.train.trainer import value_and_grad
from repro_torch.utils.remat import remat_scan
from repro_torch.utils.sharding import (P, axis_ctx_for_mesh, mesh_sizes,
                                        placements)
from repro_torch.utils.tree import tree_map

# ---------------------------------------------------------------------------
# Parameter sharding rules
# ---------------------------------------------------------------------------

# last-dim sharded on "model" (column parallel)
_COL_KEYS = frozenset({
    "wq", "wk", "wv", "w1", "w3", "w_up", "w_gates", "ffn_w1", "ffn_w3",
    "in_proj", "lm_head", "embed", "wi", "wf",
})
# dim -2 sharded on "model" (row parallel; output stays unsharded pre-psum)
_ROW_KEYS = frozenset({"wo", "w2", "w_down", "ffn_w2", "out_proj"})
# MoE stacked expert weights: expert axis is dim -3 for w1/w3 (E, dm, df)
_MOE_KEYS = frozenset({"w1", "w2", "w3"})


def _sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a ``DeviceMesh`` (or of anything with a ``shape``
    dict, as the JAX package's rule tests pass)."""
    if hasattr(mesh, "mesh_dim_names"):
        return mesh_sizes(mesh)
    return dict(mesh.shape)


def _spec_for(keys: Tuple[str, ...], shape: Tuple[int, ...],
              sizes: Dict[str, int], fsdp: bool) -> List:
    """The JAX package's ``_spec_for`` on a leaf of ``shape`` (stacked)
    reached by dict ``keys``: one entry per dim."""
    key = keys[-1]
    nd = len(shape)
    entries = [None] * nd
    moe = "moe" in keys

    def div(dim, axis):
        return dim % sizes[axis] == 0

    if nd >= 2:
        if moe and key in _MOE_KEYS and div(shape[nd - 3], "model"):
            # stacked (L, E, dm, df) or unstacked (E, dm, df):
            # expert-parallel over the E axis
            entries[nd - 3] = "model"
        elif key in _COL_KEYS and div(shape[-1], "model"):
            entries[-1] = "model"
        elif key in _ROW_KEYS and div(shape[-2], "model"):
            entries[-2] = "model"
        elif moe and key in _MOE_KEYS:
            # experts don't divide: fall back to hidden-dim tensor parallel
            if key == "w2" and div(shape[-2], "model"):
                entries[-2] = "model"
            elif div(shape[-1], "model"):
                entries[-1] = "model"
    if fsdp and nd >= 2:
        # ZeRO-3 style: storage additionally sharded over 'data' on the
        # last still-replicated divisible dim
        for i in range(nd - 1, -1, -1):
            if entries[i] is None and shape[i] > 1 and div(shape[i], "data"):
                entries[i] = "data"
                break
    return entries


def _stack_dims(cfg: ModelConfig, key: str, n: int) -> Tuple[int, ...]:
    """The leading axes the JAX package stacks the ``n`` per-layer dicts
    of list ``key`` on: (n,), or (G, n // G) for the two-axis stacks of
    xLSTM's mLSTM layers and Zamba2's groups."""
    axes = STACKED.get(key, 0)
    if axes == 1:
        return (n,)
    if axes == 2:
        from repro_torch.models import xlstm, zamba
        G = {"ssm": xlstm._layout, "hybrid": zamba._layout}[cfg.family](cfg)[0]
        return (G, n // G) if G else (0, 0)
    return ()


def eval_params(model: Model):
    """The model's params as fake tensors (``model.init`` under
    ``FakeTensorMode``, the counterpart of ``jax.eval_shape``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return model.init(torch.Generator().manual_seed(0))


def _param_specs(model: Model, mesh, fsdp: bool):
    """(spec tree, [(leaf path, dropped stack entries)] of the leaves whose
    stack dims held a mesh axis)."""
    sizes = _sizes(mesh)
    cfg = model.cfg
    dropped = []

    def walk(t, keys, path, stack):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(v, keys + (k,), f"{path}/{k}",
                            stack + (_stack_dims(cfg, k, len(v))
                                     if isinstance(v, list) else ()))
                    for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, keys, f"{path}[{i}]", stack)
                    for i, v in enumerate(t)]
        entries = _spec_for(keys, stack + tuple(t.shape), sizes, fsdp)
        if any(e is not None for e in entries[:len(stack)]):
            dropped.append((path, tuple(entries[:len(stack)])))
        return P(*entries[len(stack):])

    return walk(eval_params(model), (), "", ()), dropped


def param_specs(model: Model, mesh, fsdp: bool = True) -> Any:
    """Spec tree for the model's params (shapes from fake params; no
    alloc).

    ``fsdp=True`` (default) additionally shards weight storage over the
    'data' axis — required for the 100B+ archs whose TP=16 shard alone
    would not leave memory headroom.
    """
    return _param_specs(model, mesh, fsdp)[0]


def stack_dim_axes(model: Model, mesh, fsdp: bool = True):
    """[(leaf path, the stack dims' entries)] of the leaves whose stacked
    spec put a mesh axis on a stack dim (replicated on it in the port)."""
    return _param_specs(model, mesh, fsdp)[1]


# ---------------------------------------------------------------------------
# Activation / cache sharding
# ---------------------------------------------------------------------------


def _batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in _sizes(mesh))


def _batch_size(mesh) -> int:
    sizes = _sizes(mesh)
    out = 1
    for a in _batch_axes(mesh):
        out *= sizes[a]
    return out


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                specs: Dict[str, torch.Tensor]) -> Dict[str, P]:
    """Shard every input's batch dim over (pod, data) when divisible."""
    axes = _batch_axes(mesh)
    out = {}
    for k, v in specs.items():
        b = v.shape[0]
        if axes and b % _batch_size(mesh) == 0:
            out[k] = P(axes, *([None] * (v.ndim - 1)))
        else:
            out[k] = P(*([None] * v.ndim))
    return out


def cache_specs(cfg: ModelConfig, mesh, cache_shapes: Any,
                batch: int, seq_axis: Optional[str] = "model") -> Any:
    """Shard cache leaves: the batch dim over (pod,data), and the slot /
    sequence dim (>= 1024 slots) over ``seq_axis``.

    The batch dim is identified by its exact size (init_cache(batch, ...)
    builds every leaf with it); the slot dim is the first large divisible
    dim after it.  The port's leaves are per layer, so no layer axis can
    be mistaken for the batch.
    """
    axes = _batch_axes(mesh)
    bsz = _batch_size(mesh)
    sizes = _sizes(mesh)

    def spec(leaf):
        nd = leaf.ndim
        entries = [None] * nd
        start = 0
        if batch > 1:
            for i, d in enumerate(leaf.shape):
                if d == batch and axes and d % bsz == 0:
                    entries[i] = axes
                    start = i + 1
                    break
        if seq_axis:
            for i in range(start, nd):
                d = leaf.shape[i]
                if (entries[i] is None and d >= 1024
                        and d % sizes[seq_axis] == 0):
                    entries[i] = seq_axis
                    break
        return P(*entries)

    return tree_map(spec, cache_shapes)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def trivial(mesh) -> bool:
    """Every axis of ``mesh`` has size 1."""
    return all(s == 1 for s in _sizes(mesh).values())


def _place(t, mesh, spec):
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    pl = placements(spec, mesh)
    if t.is_meta:
        # a fresh local shard, so that a device's bytes are its shard's
        local = list(t.shape)
        for size, p in zip(mesh.shape, pl):
            if isinstance(p, Shard):
                local[p.dim] //= size
        return DTensor.from_local(torch.empty(local, dtype=t.dtype,
                                              device="meta"), mesh, pl,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return distribute_tensor(t, mesh, pl)


def to_meta(tree):
    """``tree`` with every tensor (a fake one of ``build_step``'s) as a
    meta tensor of its shape, dtype and strides."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kids = [to_meta(v) for v in tree]
        return type(tree)(*kids) if hasattr(tree, "_fields") \
            else type(tree)(kids)
    return torch.empty_strided(tree.shape, tree.stride(), dtype=tree.dtype,
                               device="meta")


def shardings(mesh, spec_tree: Any, tree: Any) -> Any:
    """``tree`` placed onto ``mesh`` by ``spec_tree`` (a spec per leaf):
    DTensors, or ``tree`` itself on a mesh of size-1 axes."""
    if trivial(mesh):
        return tree

    def walk(s, t):
        if t is None:
            return None
        if isinstance(s, P):
            return _place(t, mesh, s)
        if isinstance(t, dict):
            return {k: walk(s[k], v) for k, v in t.items()}
        kids = [walk(si, ti) for si, ti in zip(s, t)]
        return type(t)(*kids) if hasattr(t, "_fields") else type(t)(kids)

    return walk(spec_tree, tree)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


def make_train_step_fn(model: Model, opt_cfg: Optional[AdamWConfig] = None,
                       microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``microbatches > 1`` accumulates float32 gradients over equal slices
    of the batch (their mean), so the activation peak scales with
    B/microbatches while the optimizer step sees the full-batch gradient.
    As in the JAX package, the metrics are then the last slice's.  The
    AdamW update runs in place (``adamw_update``)."""
    opt_cfg = opt_cfg or AdamWConfig()

    def step(params, opt_state, batch):
        if microbatches > 1:
            n = microbatches
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            metrics = None
            for i in range(n):
                mb = {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                      for k, v in batch.items()}
                (_, metrics), g = value_and_grad(model.loss_fn, params, mb)
                grads = tree_map(
                    lambda a, gi: a + gi.to(torch.float32) / n, grads, g)
        else:
            (_, metrics), grads = value_and_grad(model.loss_fn, params, batch)
        grads = tree_map(_placed_like, grads, params)
        new_params, new_opt, om = adamw_update(opt_cfg, grads, opt_state,
                                               params)
        return new_params, new_opt, {**metrics, **om}

    return step


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its param's placements (a partial sum over the
    batch shards reduced), so that the in-place AdamW update reads whole
    gradients; a plain gradient as it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_prefill_fn(model: Model, cache_len: int):
    def step(params, batch):
        return model.prefill(params, batch, cache_len)
    return step


def make_decode_fn(model: Model, pos: int):
    """One serve_step: decode a single token at position ``pos`` against
    the full cache (the dry-run's decode shapes), on the plain path
    (``use_kernel=False``: the JAX package's default, where the port's is
    the kernel) where the model's steps take ``use_kernel``."""
    kw = {"use_kernel": False} if model.kernel_weights else {}

    def step(params, cache, tokens):
        return model.decode_step(params, cache, tokens, pos, **kw)
    return step


def _fake_inputs(specs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fake CPU tensors (under the active fake mode) of ``input_specs``'
    meta tensors."""
    return {k: torch.empty(v.shape, dtype=v.dtype) for k, v in specs.items()}


def build_step(arch_cfg: ModelConfig, shape: ShapeConfig, mesh,
               opt_cfg: Optional[AdamWConfig] = None,
               seq_shard_decode: bool = False,
               microbatches: int = 1):
    """Assemble (fn, example_args, in_specs, out_specs, donate) for one
    (arch x shape) pair on ``mesh``.  The args are fake tensors (shapes,
    dtypes and strides) — nothing is allocated.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode
    model = build_model(arch_cfg)
    pspecs = param_specs(model, mesh)
    in_meta = model.input_specs(shape)
    bspecs = batch_specs(arch_cfg, shape, mesh, in_meta)
    mode = FakeTensorMode()
    with mode:
        p_shapes = model.init(torch.Generator().manual_seed(0))
        batch = _fake_inputs(in_meta)

    if shape.kind == "train":
        fn = make_train_step_fn(model, opt_cfg, microbatches=microbatches)
        with mode:
            opt_shapes = adamw_init(p_shapes)
        opt_specs = AdamWState(step=P(), mu=pspecs, nu=pspecs)
        return (fn, (p_shapes, opt_shapes, batch),
                (pspecs, opt_specs, bspecs), None, (0, 1))

    B = shape.global_batch
    with mode:
        cache_shapes = model.init_cache(B, shape.seq_len, "cpu")
    cspecs = cache_specs(arch_cfg, mesh, cache_shapes, batch=B)

    if shape.kind == "prefill":
        fn = make_prefill_fn(model, cache_len=shape.seq_len)
        logit_spec = P(_batch_axes(mesh) or None, None) \
            if B % max(_batch_size(mesh), 1) == 0 else P(None, None)
        return (fn, (p_shapes, batch), (pspecs, bspecs),
                (logit_spec, cspecs), ())

    # decode: one token against a seq_len cache
    fn = make_decode_fn(model, pos=shape.seq_len - 1)
    tok_spec = batch_specs(arch_cfg, shape, mesh,
                           {"tokens": batch["tokens"]})["tokens"]
    return (fn, (p_shapes, cache_shapes, batch["tokens"]),
            (pspecs, cspecs, tok_spec), None, (1,))


@contextlib.contextmanager
def mesh_step(mesh):
    """The context a step runs in on ``mesh``: its axis context (hints
    redistribute) and, off a trivial mesh, DTensor's implicit replication
    of the plain tensors a step makes (masks, positions, zero buffers)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(axis_ctx_for_mesh(mesh, batch=("pod", "data"),
                                              model="model"))
        if not trivial(mesh):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            stack.enter_context(implicit_replication())
        yield


def trace_step(arch_cfg: ModelConfig, shape: ShapeConfig, mesh,
               remat: Optional[bool] = None, **kw):
    """Place one (arch x shape x mesh) step's fake args by their specs and
    run it once under the roofline's counters (``roofline.analysis
    .StepTracer``): the port's dry-run unit, where the JAX package lowers
    (``lower_step``).  Returns the tracer."""
    from repro_torch.roofline.analysis import StepFlops, StepTracer
    fn, args, in_specs, _, _ = build_step(arch_cfg, shape, mesh, **kw)
    if remat is None:
        remat = shape.kind == "train"    # layer remat only matters under AD
    # on meta tensors, not fake ones: DTensor caches its sharding decisions
    # only outside a fake mode, and a step repeats its layers' ops
    placed = tuple(shardings(mesh, s, to_meta(a))
                   for s, a in zip(in_specs, args))
    tracer = StepTracer()
    tracer.hold(placed)
    del args
    flops = StepFlops()
    # the tracer below the flop counter: the counter sees each DTensor op
    # once at its global shape, the tracer its local ops and collectives
    with mesh_step(mesh), remat_scan(remat), tracer, flops:
        out = fn(*placed)
        del out
    tracer.traced_flops = flops.total
    return tracer
