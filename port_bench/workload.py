"""The one traffic generator: a mix file's parameters and ``--seed`` give
every frame's camera pose and scene time, and which frames the run compares.

The path is the demo avatar's flight (``avatar.gd``, ``mouse_look.gd``): from
``start`` forward (camera −Z) at ``speed`` units/s, turning ``yaw_per_frame``
rad of yaw each frame of ``dt`` s, for ``frames_out`` frames, then back along
the same poses: a closed loop of ``2 · frames_out`` poses.  The seed picks the
pose the loop starts at; frame ``i`` of a run takes pose ``(start + i) mod
loop`` and scene time ``t0 + (start + i) · dt``.  Every seed runs the same
loop of poses, from another place in it.
"""

from __future__ import annotations

import math
import random

import numpy as np


def _basis(yaw: float) -> np.ndarray:
    """The fly camera's 3×3 basis (columns right, up, backward) at ``yaw``
    about +Y and no pitch, in float64."""
    cy, sy = math.cos(yaw), math.sin(yaw)
    fwd = np.array([-sy, 0.0, -cy])
    right = np.array([cy, 0.0, -sy])
    up = np.cross(right, fwd)
    return np.stack([right, up, -fwd], axis=1)


def loop_poses(path: dict) -> np.ndarray:
    """``(2 · frames_out, 4, 4)`` float32 view→world transforms of the loop."""
    pos = np.asarray(path["start"], np.float64)
    yaw = 0.0
    out = []
    step = float(path["speed"]) * float(path["dt"])
    for _ in range(int(path["frames_out"])):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = _basis(yaw)
        m[:3, 3] = pos
        out.append(m)
        yaw = (yaw + float(path["yaw_per_frame"])) % (2.0 * math.pi)
        pos = pos + _basis(yaw) @ np.array([0.0, 0.0, -1.0]) * step
    return np.stack(out + out[::-1])


class Traffic:
    """One run's traffic: ``mix`` is the parsed mix file, ``seed`` the run's."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = int(seed)
        self.poses = loop_poses(mix["path"])
        rng = random.Random(self.seed)
        self.start = rng.randrange(len(self.poses))
        cmp = mix["compare"]
        #: units (frames, or flight calls) whose outputs the run keeps and compares
        self.sampled = sorted(rng.sample(range(int(cmp["early_frames"])),
                                         int(cmp["early_samples"])))
        self.compare_last = bool(cmp["last"])
        self.height, self.width = int(mix["height"]), int(mix["width"])
        self.in_flight = int(mix["in_flight"])
        self.frames_per_unit = int(mix.get("flight_frames", 1))
        #: units in one loop of the path: a window ends at the end of one
        if len(self.poses) % self.frames_per_unit:
            raise ValueError("a flight's frames must divide the loop")
        self.period = len(self.poses) // self.frames_per_unit

    def frame(self, i: int) -> tuple:
        """``(view_to_world (4, 4) float32, scene time)`` of frame ``i``."""
        k = self.start + i
        return self.poses[k % len(self.poses)], float(self.mix["t0"]) + k * float(
            self.mix["path"]["dt"])

    def unit(self, j: int) -> tuple:
        """Unit ``j``'s frames: ``(poses (K, 4, 4) float32, times (K,))``."""
        k = self.frames_per_unit
        frames = [self.frame(j * k + f) for f in range(k)]
        return np.stack([m for m, _ in frames]), np.array([t for _, t in frames], np.float64)
