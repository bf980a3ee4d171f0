"""frame_ms: the window's milliseconds over the frames whose device work
finished inside it, the engine's frame time (``frames`` mixes)."""


def read(run):
    if run.traffic.mix["mode"] != "frames":
        return None
    frames = sum(u.frames for u in run.done())
    return run.window_ms / frames if frames else None
