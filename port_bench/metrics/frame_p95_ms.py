"""frame_p95_ms: the 95th percentile of every frame's latency in the window,
from the start of its host work (the camera, ``Scene.update``) to the end of
its device work, an event recorded after its last launch and placed on the
host clock through one anchor event (``frames`` mixes)."""

from port_bench.harness import percentile


def read(run):
    if run.traffic.mix["mode"] != "frames":
        return None
    done = run.done()
    return percentile([(u.end - u.start) * 1e3 for u in done], 95.0) if done else None
