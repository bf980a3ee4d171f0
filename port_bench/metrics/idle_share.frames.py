"""idle_share.frames: 1 − busy ÷ wall over the traced window, in %, busy the
union of all device intervals (``frames`` mixes)."""

from port_bench.harness import busy_us


def read(run):
    trace = run.trace
    if trace is None or run.traffic.mix["mode"] != "frames":
        return None
    return 100.0 * (1.0 - busy_us([(s, e) for _, s, e in trace.device]) / 1e6 / trace.wall_s)
