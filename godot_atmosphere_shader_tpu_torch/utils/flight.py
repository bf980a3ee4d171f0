"""Flying camera: the demo avatar analog.

Counterpart of ``godot_atmosphere_shader_tpu/utils/flight.py``, itself
modelled on the reference demo's ``avatar.gd`` (WASD fly movement with
speed stacking) and ``mouse_look.gd`` (yaw/pitch mouse look):

* :class:`FlyCamera` — persistent position + yaw/pitch state with
  ``move``/``look`` steps mirroring the avatar's controls;
* :func:`orbit_path` / :func:`approach_path` — scripted flight paths that
  yield camera poses for animation and benchmark sequences.

The pose math runs on the host in float64, as in the JAX module; each
:class:`Camera` is made on ``device`` (the card unless the caller asks for
the CPU).
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np

from .camera import Camera, look_at


class FlyCamera:
    """Yaw/pitch fly camera with the avatar's control surface.

    ``move`` takes a motion vector in *local* camera space (x right, y up,
    z backward — so forward is ``(0, 0, -1)``), like the avatar's
    basis-relative WASD motion; ``look`` applies yaw/pitch deltas with the
    ±90° pitch clamp of the mouse look.
    """

    def __init__(self, position=(0.0, 0.0, 0.0), yaw: float = 0.0,
                 pitch: float = 0.0, speed: float = 10.0,
                 fov_y_deg: float = 70.0, near: float = 0.1, far: float = 800.0):
        self.position = np.asarray(position, np.float64)
        self.yaw = float(yaw)
        self.pitch = float(pitch)
        self.speed = float(speed)
        self.fov_y_deg = fov_y_deg
        self.near = near
        self.far = far

    def look(self, yaw_delta: float, pitch_delta: float) -> "FlyCamera":
        self.yaw = (self.yaw + yaw_delta) % (2.0 * math.pi)
        self.pitch = float(np.clip(self.pitch + pitch_delta, -math.pi / 2, math.pi / 2))
        return self

    def basis(self) -> np.ndarray:
        """3×3 camera basis (columns: right, up, backward)."""
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        cp, sp = math.cos(self.pitch), math.sin(self.pitch)
        # yaw about +Y then pitch about local +X, Godot-style
        fwd = np.array([-sy * cp, sp, -cy * cp])
        right = np.array([cy, 0.0, -sy])
        up = np.cross(right, fwd)
        return np.stack([right, up, -fwd], axis=1)

    def move(self, local_motion, dt: float = 1.0 / 60.0,
             speed_boost: float = 1.0) -> "FlyCamera":
        """Move along the camera basis; ``speed_boost`` is the
        shift-to-go-faster multiplier."""
        m = np.asarray(local_motion, np.float64)
        n = np.linalg.norm(m)
        if n > 0:
            m = m / n
        self.position = self.position + self.basis() @ m * (self.speed * speed_boost * dt)
        return self

    def view_to_world(self) -> np.ndarray:
        """The camera's ``(4, 4)`` float32 transform, on the host."""
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.basis()
        m[:3, 3] = self.position
        return m

    def camera(self, *, device="cuda") -> Camera:
        return Camera.create(self.view_to_world(), fov_y_deg=self.fov_y_deg,
                             near=self.near, far=self.far, device=device)


def orbit_path(radius: float, height: float, frames: int,
               target=(0.0, 0.0, 0.0), fov_y_deg: float = 70.0,
               near: float = 0.1, far: float = 800.0, *, device="cuda") -> Iterator[Camera]:
    """Circular orbit around ``target``, one camera per frame."""
    for i in range(frames):
        a = 2.0 * math.pi * i / frames
        eye = (target[0] + radius * math.cos(a), target[1] + height,
               target[2] + radius * math.sin(a))
        yield Camera.create(look_at(eye, target, device=device), fov_y_deg=fov_y_deg,
                            near=near, far=far, device=device)


def approach_path(start, end, frames: int, target=(0.0, 0.0, 0.0),
                  fov_y_deg: float = 70.0, near: float = 0.1,
                  far: float = 800.0, *, device="cuda") -> Iterator[Camera]:
    """Linear dolly from ``start`` to ``end`` looking at ``target`` (the
    space→interior descent)."""
    start = np.asarray(start, np.float64)
    end = np.asarray(end, np.float64)
    for i in range(frames):
        t = i / max(frames - 1, 1)
        eye = tuple(float(c) for c in start + (end - start) * t)
        yield Camera.create(look_at(eye, target, device=device), fov_y_deg=fov_y_deg,
                            near=near, far=far, device=device)
