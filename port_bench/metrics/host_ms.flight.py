"""host_ms.flight: the host wall time of a ``Scene.render_flight`` call
(with its camera) over its K frames, the mean over the window's calls."""


def read(run):
    if run.traffic.mix["mode"] != "flight" or not run.units:
        return None
    return sum(u.host_s for u in run.units) / sum(u.frames for u in run.units) * 1e3
