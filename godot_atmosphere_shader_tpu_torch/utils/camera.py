"""Camera model and per-pixel ray generation (reverse-Z, Godot view space:
right-handed, looking down ``-Z``, ``Y`` up; ``linear_depth`` is the
Euclidean camera→point distance).

Counterpart of ``godot_atmosphere_shader_tpu/utils/camera.py``.  Every 3×3
and 4×4 transform is written as explicit multiply-adds (no ``@``), so no
reduced-precision matrix unit ever enters.

The scalar preamble of ray generation, ``tan(fov/2)`` and the aspect scale,
is computed once on the host by :func:`ray_scale` and shared by the plain
PyTorch path and the CUDA megakernel, so both build bit-identical inputs
for the per-pixel normalize.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from . import host_mirror
from .profiling import span
from .vecmath import Vec3, normalize


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera.  ``view_to_world`` is the camera's global transform."""

    view_to_world: torch.Tensor  # (4, 4) f32, rigid transform
    fov_y_rad: torch.Tensor  # 0-d
    near: torch.Tensor  # 0-d
    far: torch.Tensor  # 0-d

    @staticmethod
    def create(view_to_world=None, fov_y_deg: float = 70.0, near: float = 0.1,
               far: float = 800.0, *, device="cuda") -> "Camera":
        """Defaults match the demo avatar camera; ``fov_y_deg`` is degrees.
        A float64 numpy ``view_to_world`` (a large-world camera, as
        :func:`look_at` returns it for float64 inputs) stays float64, so
        ``Scene`` can rebase the world around it before anything is cast
        to float32.  A host value is uploaded with its host mirror
        (``host_mirror.upload``: no copy that waits for the stream), the fov
        converted to radians on the host first, in float32 as the device
        would; a tensor on a card stays where it is, with no mirror."""
        def on_card(value):
            return isinstance(value, torch.Tensor) and value.is_cuda

        def upload(value, dtype=torch.float32):
            if on_card(value):
                return torch.as_tensor(value, dtype=dtype, device=device)
            return host_mirror.upload(value, device, dtype, site="port.copy.camera_create")

        with span("port.camera.create"):
            if view_to_world is None:
                view_to_world = torch.eye(4, dtype=torch.float32)
            wide = isinstance(view_to_world, np.ndarray) and view_to_world.dtype == np.float64
            fov = fov_y_deg if on_card(fov_y_deg) else torch.as_tensor(fov_y_deg,
                                                                       dtype=torch.float32)
            return Camera(
                view_to_world=upload(view_to_world,
                                     torch.float64 if wide else torch.float32),
                fov_y_rad=upload(torch.deg2rad(fov)),
                near=upload(near),
                far=upload(far),
            )

    @property
    def world_to_view(self) -> torch.Tensor:
        return rigid_inverse(self.view_to_world)

    @property
    def position(self) -> Vec3:
        t = self.view_to_world[:3, 3]
        return Vec3(t[0], t[1], t[2])


def look_at(eye, target, up=(0.0, 1.0, 0.0), *, device="cuda"):
    """Camera (view→world) transform looking from ``eye`` toward ``target``
    (camera basis: X = right, Y = up, Z = −forward), a float32 tensor on
    ``device``.  Where any input is a float64 numpy array it is computed
    and returned as a host float64 array, as the JAX package does: the
    large-world path needs the camera position at full precision, so that
    ``Scene`` rebases the world around it before the cast to float32."""
    if any(isinstance(a, np.ndarray) and a.dtype == np.float64 for a in (eye, target, up)):
        eye = np.asarray(eye, np.float64)
        fwd = np.asarray(target, np.float64) - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.asarray(up, np.float64))
        right = right / np.linalg.norm(right)
        true_up = np.cross(right, fwd)
        m = np.eye(4)
        m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, true_up, -fwd, eye
        return m
    f32 = dict(dtype=torch.float32, device=device)
    eye = torch.as_tensor(eye, **f32)
    target = torch.as_tensor(target, **f32)
    up = torch.as_tensor(up, **f32)

    def norm(v):
        return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])

    def cross3(a, b):
        return torch.stack([a[1] * b[2] - a[2] * b[1],
                            a[2] * b[0] - a[0] * b[2],
                            a[0] * b[1] - a[1] * b[0]])

    fwd = target - eye
    fwd = fwd / norm(fwd)
    right = cross3(fwd, up)
    right = right / norm(right)
    true_up = cross3(right, fwd)
    m = torch.eye(4, **f32)
    m[:3, 0] = right
    m[:3, 1] = true_up
    m[:3, 2] = -fwd
    m[:3, 3] = eye
    return m


def rigid_inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid (rotation + translation) 4×4 transform, with the
    translation as explicit scalar multiply-adds."""
    rt = m[:3, :3].T
    t = m[:3, 3]
    nt = -(rt[:, 0] * t[0] + rt[:, 1] * t[1] + rt[:, 2] * t[2])
    out = torch.eye(4, dtype=m.dtype, device=m.device)
    out[:3, :3] = rt
    out[:3, 3] = nt
    return out


def ray_scale(camera: Camera, height: int, width: int) -> Tuple[float, float]:
    """The ray-generation preamble, computed once on the host.

    Returns ``(sx, sy)`` with ``sy = tan(fov_y / 2)`` (correctly rounded to
    f32) and ``sx = f32(f32(width / height) · sy)``: view-space ray
    directions are ``normalize(ndc_x · sx, ndc_y · sy, −1)``.  Both the plain
    path and the kernel consume these two numbers, never their own ``tan``.
    """
    half = np.float32(float(camera.fov_y_rad)) * np.float32(0.5)
    sy = np.float32(math.tan(float(half)))
    sx = np.float32(np.float32(width / height) * sy)
    return float(sx), float(sy)


def pixel_ndc(height: int, width: int, *, device, rows=None,
              cols=None, row0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """NDC x per column ``(cols,)`` and y per row ``(rows,)`` at pixel
    centers of a ``height × width`` frame, from frame row ``row0``
    (``rows``/``cols`` default to the frame and may run past its edge);
    ``(0, 0)`` is the top-left pixel."""
    ix = torch.arange(width if cols is None else cols, dtype=torch.float32, device=device)
    iy = torch.arange(height if rows is None else rows, dtype=torch.float32, device=device)
    iy = iy + float(row0)
    ndc_x = 2.0 * (ix + 0.5) / width - 1.0
    ndc_y = 1.0 - 2.0 * (iy + 0.5) / height
    return ndc_x, ndc_y


def world_ray_dirs(camera: Camera, height: int, width: int, rows=None,
                   cols=None, row0: int = 0) -> Vec3:
    """Normalized per-pixel ray directions rotated into world space, on a
    ``rows × cols`` grid of the ``height × width`` frame from frame row
    ``row0`` (default: the frame itself)."""
    device = camera.view_to_world.device
    rows = height if rows is None else rows
    cols = width if cols is None else cols
    sx, sy = ray_scale(camera, height, width)
    ndc_x, ndc_y = pixel_ndc(height, width, device=device, rows=rows, cols=cols, row0=row0)
    d = normalize(Vec3((ndc_x * sx).expand(rows, cols),
                       (ndc_y * sy)[:, None].expand(rows, cols),
                       torch.full((rows, cols), -1.0, device=device)))
    r = camera.view_to_world.cpu().tolist()
    return transform_dir(r, d)


def transform_point(m, p: Vec3) -> Vec3:
    """Apply a 4×4 affine transform (w assumed 1); ``m`` is indexable as
    ``m[i][j]`` (a tensor or nested lists of host floats)."""
    return Vec3(
        m[0][0] * p.x + m[0][1] * p.y + m[0][2] * p.z + m[0][3],
        m[1][0] * p.x + m[1][1] * p.y + m[1][2] * p.z + m[1][3],
        m[2][0] * p.x + m[2][1] * p.y + m[2][2] * p.z + m[2][3],
    )


def transform_dir(m, d: Vec3) -> Vec3:
    """Apply only the linear part (w = 0)."""
    return Vec3(
        m[0][0] * d.x + m[0][1] * d.y + m[0][2] * d.z,
        m[1][0] * d.x + m[1][1] * d.y + m[1][2] * d.z,
        m[2][0] * d.x + m[2][1] * d.y + m[2][2] * d.z,
    )


def projection_coeffs(camera: Camera, reverse_z: bool):
    """``(A, B)`` of the projection's depth row: ``clip_z = A·z_view + B·w``."""
    n, f = camera.near, camera.far
    if reverse_z:
        return n / (f - n), n * f / (f - n)
    return -f / (f - n), -f * n / (f - n)


def projection_matrix(camera: Camera, aspect: float, reverse_z: bool = True) -> torch.Tensor:
    """The 4×4 perspective projection (Vulkan NDC, reverse-Z by default)."""
    fy = 1.0 / torch.tan(camera.fov_y_rad * 0.5)
    a, b = projection_coeffs(camera, reverse_z)
    p = torch.zeros((4, 4), dtype=torch.float32, device=camera.fov_y_rad.device)
    p[0, 0] = fy / aspect
    p[1, 1] = fy
    p[2, 2] = a
    p[2, 3] = b
    p[3, 2] = -1.0
    return p


def linear_depth_from_buffer(camera: Camera, nonlinear_depth: torch.Tensor, height: int,
                             width: int, reverse_z: bool = True) -> torch.Tensor:
    """Euclidean camera→point distance (H, W) from a nonlinear depth buffer
    (``planet_atmosphere_main.gdshaderinc:128-138``: NDC → view with the
    w-divide → distance; the world transform drops out)."""
    aspect = width / height
    fy = 1.0 / torch.tan(camera.fov_y_rad * 0.5)
    a, b = projection_coeffs(camera, reverse_z)
    ndc_x, ndc_y = pixel_ndc(height, width, device=nonlinear_depth.device)
    # the inverse projection of (ndc, d, 1): xyz = (x·aspect/f, y/f, −1), w = (d + a)/b
    inv_w = 1.0 / ((nonlinear_depth + a) / b)
    px = ndc_x[None, :] * (aspect / fy) * inv_w
    py = (ndc_y / fy)[:, None] * inv_w
    pz = -inv_w
    return torch.sqrt(px * px + py * py + pz * pz)


def nonlinear_depth_from_view_z(camera: Camera, z_view: torch.Tensor,
                                reverse_z: bool = True) -> torch.Tensor:
    """Encode a (negative) view-space z into the nonlinear depth value."""
    a, b = projection_coeffs(camera, reverse_z)
    return (a * z_view + b) / (-z_view)


def background_depth(reverse_z: bool = True) -> float:
    """Depth-buffer clear value (the far plane)."""
    return 0.0 if reverse_z else 1.0
