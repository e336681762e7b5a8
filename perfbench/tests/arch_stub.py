"""A stand-in architecture module for the tests of the harness's
dispatch (``test_perfbench_arch.py``): BLOOM's functions, each counting
its calls in ``CALLS``.  A configuration whose ``"reference"`` names
this file runs the BLOOM decoder through it."""
from perfbench.reference import bloom

CALLS = {}


def _counted(name):
    fn = getattr(bloom, name)

    def call(*args, **kw):
        CALLS[name] = CALLS.get(name, 0) + 1
        return fn(*args, **kw)
    return call


file_sizes = _counted("file_sizes")
program_sizes = _counted("program_sizes")
scaled_program = _counted("scaled_program")
make_params = _counted("make_params")
forward_rows = _counted("forward_rows")
prompt_flops = _counted("prompt_flops")
tokens_flops = _counted("tokens_flops")
