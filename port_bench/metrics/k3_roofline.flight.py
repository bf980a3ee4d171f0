"""k3_roofline.flight: K3's least time (``roofline/k3.py``: 48 B and 300
operations a pixel, against the data-sheet peaks) over its device time, in
%, over every ``taa_kernel`` launch of the trace."""

from port_bench.harness import kernels
from port_bench.roofline.k3 import resolve_bound_ms

#: the trace name of K3's kernel
K3_NAMES = ("taa_kernel",)


def read(run):
    trace = run.trace
    if trace is None or run.traffic.mix["mode"] != "flight":
        return None
    k3 = kernels(trace, K3_NAMES)
    if not k3:
        return None
    bound = resolve_bound_ms(run.traffic.height, run.traffic.width) * len(k3)
    return 100.0 * bound / (sum(e - s for _, s, e in k3) / 1e3)
