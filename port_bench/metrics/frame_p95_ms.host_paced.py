"""frame_p95_ms.host_paced: ``frame_p95_ms``, the 95th percentile of every
frame's latency in the window, read in a cell whose frames the host
preamble paces.  There the tail follows the shared host's speed from run to
run, too widely for an end-to-end bound, so it is kept per layer."""

from port_bench.harness import load_metric


def read(run):
    return load_metric("frame_p95_ms").read(run)
