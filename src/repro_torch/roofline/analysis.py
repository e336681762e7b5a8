"""Three-term roofline analysis of a traced step (port of
``repro.roofline.analysis``).

  compute    = FLOPs / (chips x peak bf16 FLOP/s)
  memory     = HBM bytes / (chips x HBM bytes/s)
  collective = collective bytes / (chips x chip-to-chip bytes/s)

with ``config.H100`` as the default hardware (the JAX package's is its TPU
v5e).  Two sources are recorded for every term:

* **Traced** — one run of the step under ``StepTracer`` (a
  ``TorchDispatchMode``) and ``FlopCounterMode``, over meta tensors placed
  on a fake process group's mesh (``launch.dryrun``).  The tracer sees the
  local ops DTensor runs on one device's shards, so ``traced_bytes`` (the
  operands and results of every non-view op) and ``bytes_per_device`` (the
  peak of the live local storages during the step) are one device's;
  ``traced_flops`` counts the whole step (``FlopCounterMode`` counts each
  DTensor op once at its global shape and not its local ops).
* **Analytic** — the paper's own cost model (core/costmodel.py) evaluated
  at the (arch x shape): trusted for scale, used for the headline terms
  and the bottleneck call.

The JAX package parses collectives out of the compiled HLO text and
multiplies those inside a ``while`` body by its trip count, because XLA
costs a loop body once.  A torch step runs eagerly: every layer's and
every chunk's collectives are dispatched, one by one, so the tracer counts
the ``_c10d_functional`` ops themselves, by kind, in bytes of output volume
(the reference's rule: the tensor each device receives), and no loop needs
a trip count.

MODEL_FLOPS = 6·N_active·tokens (train) / 2·N_active·tokens (forward);
useful_compute_ratio = MODEL_FLOPS / analytic_total_flops (<= 1; the gap
is attention reads, recompute and padding).
"""
from __future__ import annotations

import sys
import weakref
from typing import Any, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.config import H100, HardwareSpec, ModelConfig, ShapeConfig
from repro_torch.core.costmodel import CostModel

# _c10d_functional op -> the JAX package's collective kind
_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sharding_propagation() -> bool:
    """Whether the op being dispatched comes from DTensor's sharding
    propagation (which runs an op on global-shape tensors for its output's
    metadata) and not from the step."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name.endswith("_sharding_prop.py"):
            return True
        if "repro_torch" in name:
            return False
        f = f.f_back
    return False


class StepFlops(FlopCounterMode):
    """``FlopCounterMode`` summing the whole step's FLOPs in ``total``: a
    DTensor op counts once at its global shape, and a local op inside
    ``utils.sharding.head_local`` (attention on each device's shard) counts
    times the number of distinct shards its work splits into."""

    def __init__(self):
        from repro_torch.utils.sharding import clear_regions
        super().__init__(display=False)
        self.total = 0
        clear_regions()

    def _count_flops(self, func_packet, out, args, kwargs):
        from repro_torch.utils.sharding import local_shards
        if func_packet in self.flop_registry:
            self.total += local_shards() * self.flop_registry[func_packet](
                *args, **kwargs, out_val=out)
        return out


class StepTracer(TorchDispatchMode):
    """Counts what one device does in a step: collectives by kind (bytes of
    output volume), the bytes every non-view op reads and writes, and the
    peak of live local storage bytes (a storage counts from the op that
    made it until it is freed; in-place updates, AdamW's and the cache
    writes, make none, which plays the role of the JAX package's buffer
    donation).  DTensor ops are passed on (``NotImplemented``), so the
    tracer sees the local ops and the collectives DTensor runs; the ops of
    its sharding propagation (on global-shape tensors) count for nothing.
    """

    def __init__(self):
        super().__init__()
        self.collectives: Dict[str, float] = {}
        self.n_collectives = 0
        self.traced_bytes = 0.0
        self.traced_flops = 0.0
        self.live = 0
        self.peak = 0
        self._storages = WeakIdKeyDictionary()

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def hold(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live (the step's
        inputs)."""
        for t in _tensors(tree):
            self._track(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if _sharding_propagation():
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "_dtensor") \
                and name in _COLLECTIVE_KINDS:
            kind = _COLLECTIVE_KINDS[name]
            self.collectives[kind] = self.collectives.get(kind, 0.0) \
                + sum(_nbytes(t) for t in _tensors(out))
            self.n_collectives += 1
        elif not func.is_view:
            self.traced_bytes += sum(_nbytes(t) for t in _tensors(
                (args, kwargs, out)))
        for t in _tensors(out):
            self._track(t)
        return out

    def collective_totals(self) -> Dict[str, float]:
        out = dict(self.collectives)
        out["total"] = sum(self.collectives.values())
        return out


# ---------------------------------------------------------------------------
# Analytic terms (the paper's cost model at the arch x shape)
# ---------------------------------------------------------------------------


def analytic_costs(cfg: ModelConfig, shape: ShapeConfig
                   ) -> Tuple[float, float]:
    """(total FLOPs, total HBM bytes) for one step of this shape."""
    cm = CostModel(cfg)
    B, S = shape.global_batch, shape.seq_len
    W = cm.weight_bytes()                      # bf16 weight bytes
    act = 2.0 * cfg.d_model * cfg.n_layers     # bytes/token residual traffic
    kv_scale = cfg.kv_bits / 16.0              # int8 KV halves cache bytes
    if shape.kind == "train":
        fwd = cm.prefill_flops(S, B)
        flops = 3.0 * fwd                      # fwd + 2x bwd
        bytes_ = 3.0 * (W + 8.0 * act * B * S) + 8.0 * W   # + AdamW f32 I/O
    elif shape.kind == "prefill":
        flops = cm.prefill_flops(S, B)
        bytes_ = W + kv_scale * cm.kv_bytes_prefill(S, B) \
            + 8.0 * act * B * S
    else:   # decode: ONE token against an S-token cache
        flops = B * cm.decode_flops(S, [2])    # 1 autoregressive iteration
        bytes_ = W + kv_scale * cm.kv_bytes_prefill(S, B) + 8.0 * act * B
    return flops, bytes_


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D (train) / 2·N·D (forward-only), N = active params."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def roofline_terms(flops: float, bytes_: float, coll_bytes: float,
                   chips: int, hw: HardwareSpec = H100) -> Dict[str, float]:
    """All three terms in seconds (aggregate work / aggregate capability)."""
    return {
        "t_compute": flops / (chips * hw.peak_flops),
        "t_memory": bytes_ / (chips * hw.hbm_bw),
        "t_collective": coll_bytes / (chips * hw.ici_bw),
    }


def dominant_term(terms: Dict[str, float]) -> str:
    return max(("t_compute", "t_memory", "t_collective"),
               key=lambda k: terms[k])


def analyze_traced(cfg: ModelConfig, shape: ShapeConfig, mesh,
                   tracer: StepTracer, t_trace: float,
                   hw: HardwareSpec = H100) -> Dict[str, Any]:
    """Full §Roofline record for one traced combination (the JAX
    package's ``analyze_lowered``, with the traced counts named for what
    they are)."""
    chips = mesh.size()
    coll = tracer.collective_totals()
    a_flops, a_bytes = analytic_costs(cfg, shape)
    terms = roofline_terms(a_flops, a_bytes, coll["total"], chips, hw)
    mf = model_flops(cfg, shape)
    return {
        "chips": chips,
        "analytic_flops": a_flops,
        "analytic_bytes": a_bytes,
        "traced_flops": float(tracer.traced_flops),   # the whole step
        "traced_bytes": tracer.traced_bytes,          # one device
        "collective_bytes": coll["total"],
        "collectives": {k: v for k, v in coll.items() if k != "total"},
        "bytes_per_device": float(tracer.peak),
        "fits": tracer.peak <= hw.hbm_bytes,
        **terms,
        "bottleneck": dominant_term(terms),
        "model_flops": mf,
        "useful_compute_ratio": mf / a_flops if a_flops else 0.0,
        "t_trace_s": t_trace,
    }
