"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``), each
beside its plain PyTorch version; ``ops`` is the entry point."""
