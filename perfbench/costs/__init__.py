"""Operations and bytes of one call of each kernel: frozen functions of
the shapes, whatever implements them.  Each kernel's module names the
device functions that make up one call (``KERNELS``: substrings of the
names in the profiler's trace) and gives ``cost(...) -> (ops, bytes)``.
Bytes count each input read once and each output written once.  The
model FLOPs of served tokens are the architecture's, in its module
(the configuration file's ``"reference"``)."""
