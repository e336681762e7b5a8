"""The decode loop as one CUDA graph: a captured decode step inside the
WHILE node of ``csrc/decode_loop.cu``.

The JAX package runs its decode loops as one ``lax.while_loop`` whose
``cond`` ("t < t_end and some row can emit") is evaluated on the device
(``repro/serving/engine.py``: ``_decode_loop_fn``, ``_decode_chunk_fn``,
``_decode_chunk_paged_fn``).  Here the serving engine captures one step
with PyTorch (``torch.cuda.CUDAGraph(keep_graph=True)``), and
:class:`DeviceLoop` wraps that graph in a conditional WHILE node whose
condition kernel reads the same state: one launch runs the loop to its
early exit, with no host work per step.

Kernel launches: the wrappers of the step's kernels count a launch in
Python when the step is captured, which a replay does not repeat.  So a
loop keeps the counts of one step (``launches``) and the device count of
iterations it has run (``iters``, advanced by the condition kernel); the
engine reads ``iters`` back inside the device->host copy it makes anyway
and calls :meth:`DeviceLoop.count`, which adds ``launches`` once for each
iteration run since the last read.  ``LAUNCHES["decode_loop"]`` counts
the loop graph's own launches, and ``kernel_nodes`` the kernels a captured
step holds, what each iteration launches on the device.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build

# launches of the loop graph (one a segment); its iterations launch the
# step's kernels, counted under their own names
LAUNCHES = {"decode_loop": 0}


def kernel_nodes(graph) -> int:
    """The kernel nodes of a captured ``torch.cuda.CUDAGraph`` (made with
    ``keep_graph=True``), read from its ``raw_cuda_graph()`` after the
    capture: the kernels one replay launches."""
    n = ctypes.c_longlong()
    rc = _build.library("decode_loop").graph_kernel_nodes(
        graph.raw_cuda_graph(), ctypes.byref(n))
    _build.check(rc, "graph_kernel_nodes")
    return int(n.value)


class DeviceLoop:
    """A captured step ``graph`` (kept alive: its memory is the graph
    pool's) looped on the device while ``t < t_end`` and some row has
    ``not done and lengths < caps``.  ``t``, ``t_end``: int32 0-d;
    ``lengths``: (B,) int64; ``caps``: (B,) int32; ``done``: (B,) bool, all
    CUDA tensors at the addresses the step graph reads and writes."""

    def __init__(self, graph, t, t_end, lengths, caps, done,
                 launches: Dict[str, int]):
        for name, x, dtype, shape in (
                ("t", t, torch.int32, ()), ("t_end", t_end, torch.int32, ()),
                ("lengths", lengths, torch.int64, lengths.shape[:1]),
                ("caps", caps, torch.int32, lengths.shape[:1]),
                ("done", done, torch.bool, lengths.shape[:1])):
            if not x.is_cuda or x.dtype != dtype \
                    or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
                raise ValueError(f"{name}: need a contiguous CUDA {dtype} "
                                 f"tensor of shape {tuple(shape)}, got "
                                 f"{x.dtype} {tuple(x.shape)} on {x.device}")
        self.graph = graph
        self.launches = dict(launches)
        self.iters = torch.zeros((), dtype=torch.int64, device=t.device)
        self.counted = 0
        self._lib = _build.library("decode_loop")
        handle = ctypes.c_void_p()
        rc = self._lib.decode_loop_build(
            graph.raw_cuda_graph(), t.data_ptr(), t_end.data_ptr(),
            lengths.data_ptr(), caps.data_ptr(), done.data_ptr(),
            lengths.shape[0], self.iters.data_ptr(), ctypes.byref(handle))
        _build.check(rc, "decode_loop_build")
        self._exec = handle

    def launch(self) -> None:
        """Run the loop to its exit on the current stream (one graph
        launch; the host does not wait)."""
        rc = self._lib.decode_loop_launch(
            self._exec, torch.cuda.current_stream(self.iters.device)
            .cuda_stream)
        _build.check(rc, "decode_loop_launch")
        LAUNCHES["decode_loop"] += 1

    def count(self, iters: int) -> None:
        """Add one step's launches for each iteration run since the last
        read; ``iters`` is ``self.iters`` as read back."""
        from repro_torch.kernels import ops
        ops.add_launch_counts(self.launches, int(iters) - self.counted)
        self.counted = int(iters)

    def __del__(self):
        if getattr(self, "_exec", None):
            self._lib.decode_loop_destroy(self._exec)
            self._exec = None
