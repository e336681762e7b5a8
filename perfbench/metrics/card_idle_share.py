"""The card's idle share without the profiler: 1 - (the union of the
program's device intervals, ``dev.prefill``, ``dev.decode`` and
``dev.read_back``, CUDA events placed on the host clock) / (the window
less the profiled sub-window).  Prints the ten longest idle gaps and the
idle seconds by name, each gap named by the innermost program or harness
span covering its middle."""
import sys

from perfbench.harness.program_trace import window


def read(run):
    w = window(run)
    if w is None or not w.intervals:
        return None
    span = w.length_s()
    if span <= 0:
        return None
    gaps = [(b - a, w.name_at((a + b) / 2)) for a, b in w.gaps()]
    by_name = {}
    for s, name in gaps:
        by_name[name] = by_name.get(name, 0.0) + s
    idle = sum(s for s, _ in gaps)
    print(f"card idle {idle:.4f} s of {span:.4f} s; longest gaps: "
          + ", ".join(f"{name} {1e3 * s:.2f} ms"
                      for s, name in sorted(gaps, reverse=True)[:10]),
          file=sys.stderr)
    print("card idle by span: " + ", ".join(
        f"{name} {1e3 * s:.1f} ms ({100 * s / idle:.1f} %)"
        for name, s in sorted(by_name.items(), key=lambda kv: -kv[1])),
        file=sys.stderr)
    return 100.0 * (1.0 - w.busy_s() / span)
