"""d2h_copies.frames: device→host copies per frame, the ``Memcpy DtoH``
device events of the trace over the frames it traced.  Each copy stalls the
host until the stream drains."""


def read(run):
    trace = run.trace
    if trace is None or run.traffic.mix["mode"] != "frames" or not trace.units:
        return None
    copies = sum(1 for name, _, _ in trace.device if "DtoH" in name)
    return copies / sum(u.frames for u in trace.units)
