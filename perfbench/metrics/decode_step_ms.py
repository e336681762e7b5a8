"""The device's ms a decode-loop iteration: the program's ``dev.decode``
intervals (CUDA events around each launch of the device loop) summed
over the window's unprofiled data-plane calls, over the loop iterations
the program read back in them.  Prints each call's step ms in order with
the process's age at the call, the call's host ms beside its device
intervals' ms, and the last SM clock, power and clock-event reasons read
before it."""
import sys

from perfbench.harness.program_trace import window
from perfbench.run import _process_start


def read(run):
    w = window(run)
    if w is None:
        return None
    calls = [c for c in w.calls()
             if c["iters"] and c["dev"].get("dev.decode")]
    if not calls:
        return None
    start = _process_start()            # on the perf_counter clock
    lines = []
    for c in calls:
        g = w.gauge_at(c["t0"])
        card = f"{g.sm_mhz} MHz {g.power_w:.1f} W reasons {g.reasons:#x}" \
            if g is not None else "no gauge"
        age = f"{c['t0'] - start:.2f} s"
        dev = " ".join(f"{k[4:]} {1e3 * v:.3f}"
                       for k, v in sorted(c["dev"].items()))
        lines.append(f"  call {c['index']} age {age}: "
                     f"{1e3 * c['dev']['dev.decode'] / c['iters']:.4f} ms x "
                     f"{c['iters']}; host {1e3 * c['host_s']:.3f} ms, "
                     f"device ms {dev}; {card}")
    print("decode_step_ms by call:\n" + "\n".join(lines), file=sys.stderr)
    return 1e3 * sum(c["dev"]["dev.decode"] for c in calls) \
        / sum(c["iters"] for c in calls)
