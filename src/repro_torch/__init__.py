"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

The control plane (``config``, ``core``, ``serving.runtime``,
``serving.faults``) is a copy of the JAX package's, with only the import
lines changed; the data plane (``quant``, ``kernels``, ``models``,
``serving.engine``) is written in PyTorch, with hand-written CUDA kernels
for the TPU kernels on its path.  Nothing here imports ``jax`` or
``repro``.
"""
