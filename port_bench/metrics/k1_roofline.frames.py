"""k1_roofline.frames: K1's least time over its device time, in %, over a
sample of the traced frames drawn from the seed: each sampled frame's work
reckoned from its own pose and time (``roofline/k1_work.py``) at the frozen
per-unit counts and the data-sheet peaks, against that frame's K1 launch in
the trace (the traced frames' launches in order, one each).  Only the
procedural instance and the fixed texture instance are reckoned: another K1
kernel in the trace fails the run."""

import random

from port_bench.harness import kernels
from port_bench.roofline.k1_work import frame_bound_ms, frame_work

#: the trace names of K1's kernels
K1_NAMES = ("megakernel_gen", "megakernel_clear", "megakernel_tex", "tex_choice_kernel")
#: traced frames whose work is reckoned
SAMPLE = 8


def reckoned(name: str) -> bool:
    """The instances this metric reckons: ``megakernel_gen`` and the fixed
    ``megakernel_tex`` (not ``megakernel_tex_general``)."""
    return "megakernel_gen" in name or ("megakernel_tex" in name
                                         and "megakernel_tex_general" not in name)


def read(run):
    trace = run.trace
    if trace is None or run.traffic.mix["mode"] != "frames" or not trace.units:
        return None
    k1 = kernels(trace, K1_NAMES)
    if not k1 or not all(reckoned(name) for name, _, _ in k1):
        return None
    units = trace.units
    if len(k1) != len(units):
        raise RuntimeError(f"{len(k1)} K1 launches in the trace for {len(units)} frames")
    rng = random.Random(run.traffic.seed)
    picks = sorted(rng.sample(range(len(units)), min(SAMPLE, len(units))))
    t = run.traffic
    bound = device = 0.0
    for j in picks:
        pose, time_s = t.frame(units[j].index)
        work = frame_work(run.ref_scene, pose, time_s, t.height, t.width)
        bound += frame_bound_ms(work, run.ref_scene.config, t.height, t.width)
        device += (k1[j][2] - k1[j][1]) / 1e3
    return 100.0 * bound / device
