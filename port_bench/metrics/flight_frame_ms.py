"""flight_frame_ms: the window's milliseconds over the flight frames whose
device work finished inside it (``flight`` mixes; a call's frames finish
with its last launch)."""


def read(run):
    if run.traffic.mix["mode"] != "flight":
        return None
    frames = sum(u.frames for u in run.done())
    return run.window_ms / frames if frames else None
