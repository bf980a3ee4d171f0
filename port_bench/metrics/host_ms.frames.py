"""host_ms.frames: the mean host wall time of a frame inside the program's
calls (the camera, ``Scene.update`` and ``Scene.render``), from the
harness's own spans around them, over the window's frames."""


def read(run):
    if run.traffic.mix["mode"] != "frames" or not run.units:
        return None
    return sum(u.host_s for u in run.units) / len(run.units) * 1e3
