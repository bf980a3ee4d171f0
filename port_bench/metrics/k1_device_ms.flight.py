"""k1_device_ms.flight: K1's device milliseconds per flight frame in the
trace.  K1 is every frame kernel of ``csrc/megakernel.cu``; none in the
trace reads nothing, and the run fails."""

from port_bench.harness import kernels

#: the trace names of K1's kernels
K1_NAMES = ("megakernel_gen", "megakernel_clear", "megakernel_tex", "tex_choice_kernel")


def read(run):
    trace = run.trace
    if trace is None or run.traffic.mix["mode"] != "flight" or not trace.units:
        return None
    k1 = kernels(trace, K1_NAMES)
    if not k1:
        return None
    return sum(e - s for _, s, e in k1) / 1e3 / sum(u.frames for u in trace.units)
