"""Sun optical depth: the reference's 256×256 LUT (bake, bilinear lookup,
rebake-on-change cache) and its gather-free analytic replacement.

Counterpart of ``godot_atmosphere_shader_tpu/ops/optical_depth.py``.  The
LUT is plain PyTorch, as the JAX bake is plain XLA: rows index the height
ratio (v), columns the ray elevation ``u = 0.5 + 0.5·dot(up, dir)``
(``optical_depth.gdshader:45-69``); each texel is a 64-step left-endpoint
sum along the ray through the shell, with the reference's extra
``· density`` (``:27``), summed in the JAX bake's order.
"""

from __future__ import annotations

import numpy as np
import torch

from .vecmath import RAY_SPHERE_MISS, Vec3, clamp, ray_sphere
from .density import atmosphere_density

LUT_RESOLUTION = 256  # optical_depth_baker.gd:24
LUT_BAKE_STEPS = 64  # optical_depth.gdshader:18


def _fma(a, b, c):
    """``a·b + c`` rounded once to float32 (the product and sum in float64:
    exact for float32 inputs but for a rare double rounding)."""
    return (a.double() * b + c).float()


def bake_optical_depth(planet_radius, atmosphere_height, density,
                       resolution: int = LUT_RESOLUTION, steps: int = LUT_BAKE_STEPS, *,
                       device="cuda") -> torch.Tensor:
    """The optical-depth LUT, ``(resolution, resolution)`` float32 on
    ``device``: rows the height ratio, columns the ray elevation, each a
    ``steps``-step left-endpoint sum in float32, step by step in order.  The
    multiply-adds that XLA contracts in the JAX bake on the CPU (the ray's
    elevation and height, its shell distance, each step's position, radius
    and sum) are rounded once here too, so the bake is the JAX bake's to a
    few float32 ulps on any device."""
    f32 = dict(dtype=torch.float32, device=device)
    r = torch.as_tensor(planet_radius, **f32)
    h = torch.as_tensor(atmosphere_height, **f32)
    dens = torch.as_tensor(density, **f32)
    idx = torch.arange(resolution, **f32)
    u = ((idx[None, :] + 0.5) / resolution).expand(resolution, resolution)
    v = ((idx[:, None] + 0.5) / resolution).expand(resolution, resolution)
    # uv → 2-D ray from (0, pos_y) along (dir_x, dir_y)
    # (optical_depth.gdshader:48-55); the third component is 0
    dir_y = 2.0 * u - 1.0
    dir_x = torch.sqrt(torch.clamp(_fma(-dir_y, dir_y, torch.ones_like(dir_y)), min=0.0))
    pos_y = _fma(h, v, r)
    # its exit from the shell (ray_sphere about the origin; it starts inside)
    b = pos_y * dir_y
    qx, qy = -(dir_x * b), _fma(-dir_y, b, pos_y)
    ra = r + h
    hh = _fma(ra, ra, -_fma(qx, qx, qy * qy))
    miss = hh < 0.0
    sq = torch.sqrt(torch.where(miss, 1.0, torch.clamp(hh, min=1e-12)))
    t0 = torch.where(miss, RAY_SPHERE_MISS, -b - sq)
    t1 = torch.where(miss, RAY_SPHERE_MISS, -b + sq)
    step_len = (t1 - torch.clamp(t0, min=0.0)) / float(steps)
    od = torch.zeros_like(step_len)
    for i in range(steps):
        t = step_len * float(i)
        px = dir_x * t
        py = _fma(dir_y, t, pos_y)
        d = torch.sqrt(_fma(px, px, py * py))
        od = _fma(atmosphere_density(d, r, h, dens) * step_len, dens, od)
    return od


def sample_bilinear_clamp(tex: torch.Tensor, u, v) -> torch.Tensor:
    """GL ``texture()`` with clamp-to-edge on a 2-D map ``tex`` ``[rows=v,
    cols=u]``, texel centers at ``(i + 0.5) / N``."""
    rows, cols = tex.shape
    x = torch.clamp(u * cols - 0.5, 0.0, cols - 1.0)
    y = torch.clamp(v * rows - 0.5, 0.0, rows - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=cols - 1)
    y1 = torch.clamp(y0 + 1, max=rows - 1)
    fx = x - x0.to(torch.float32)
    fy = y - y0.to(torch.float32)
    flat = tex.reshape(-1)
    v00 = torch.take(flat, y0 * cols + x0)
    v01 = torch.take(flat, y0 * cols + x1)
    v10 = torch.take(flat, y1 * cols + x0)
    v11 = torch.take(flat, y1 * cols + x1)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy


def get_baked_optical_depth(pos: Vec3, direction: Vec3, planet_center: Vec3,
                            lut: torch.Tensor, planet_radius, atmosphere_height):
    """``get_baked_optical_depth`` (``atmosphere_funcs_v2.gdshaderinc:14-29``):
    the LUT at the sample's height ratio and the sun direction's
    elevation."""
    rel = pos - planet_center
    dist = torch.sqrt(rel.x * rel.x + rel.y * rel.y + rel.z * rel.z)
    height_ratio = torch.clamp((dist - planet_radius) / atmosphere_height, 0.0, 1.0)
    inv = 1.0 / dist
    up_dot_dir = (rel.x * direction.x + rel.y * direction.y + rel.z * direction.z) * inv
    return sample_bilinear_clamp(lut, 0.5 + 0.5 * up_dot_dir, height_ratio)


def optical_depth_reference(pos: Vec3, direction: Vec3, planet_center: Vec3,
                            planet_radius, atmosphere_height, density,
                            steps: int = LUT_BAKE_STEPS):
    """The LUT's integral evaluated directly for arbitrary 3-D rays: the
    bake's left-endpoint sum and its ``· density`` factor."""
    t0, t1 = ray_sphere(planet_center, planet_radius + atmosphere_height, pos, direction)
    step_len = torch.where(t0 != t1, t1 - torch.clamp(t0, min=0.0), 0.0) / float(steps)
    od = torch.zeros_like(step_len)
    for i in range(steps):
        p = pos + direction * (step_len * float(i))
        rel = p - planet_center
        d = torch.sqrt(rel.x * rel.x + rel.y * rel.y + rel.z * rel.z)
        od = od + atmosphere_density(d, planet_radius, atmosphere_height, density) \
            * step_len * density
    return od


class OpticalDepthCache:
    """The reference node's rebake-on-change (``planet_atmosphere.gd:79-81,
    217-218, 230-253``): one bake per ``(planet_radius, atmosphere_height,
    density)``, kept on ``device``; ``bake_count`` counts the bakes."""

    def __init__(self, resolution: int = LUT_RESOLUTION, steps: int = LUT_BAKE_STEPS, *,
                 device="cuda"):
        self._cache = {}
        self.resolution = resolution
        self.steps = steps
        self.device = torch.device(device)
        self.bake_count = 0

    def get(self, planet_radius: float, atmosphere_height: float, density: float):
        key = (float(planet_radius), float(atmosphere_height), float(density))
        lut = self._cache.get(key)
        if lut is None:
            lut = bake_optical_depth(*key, resolution=self.resolution, steps=self.steps,
                                     device=self.device)
            self._cache[key] = lut
            self.bake_count += 1
        return lut


def gauss_legendre_01(quad_points: int):
    """Gauss–Legendre nodes and weights mapped onto [0, 1] (host doubles),
    from ``numpy.polynomial.legendre.leggauss`` as in the JAX package."""
    xs, ws = np.polynomial.legendre.leggauss(quad_points)
    return tuple(float(v) for v in (xs + 1.0) * 0.5), tuple(float(v) for v in ws * 0.5)


def optical_depth_analytic(pos: Vec3, direction: Vec3, planet_center: Vec3,
                           planet_radius, atmosphere_height, density,
                           quad_points: int = 8, clamp_to_shell: bool = True):
    """The integral the LUT approximates (incl. its extra ``· density``), in
    closed form per sample: the ray's radial profile is split at the ground
    crossings, the below-surface span contributes ``density²·length`` exactly
    and each smooth span integrates with Gauss–Legendre quadrature."""
    rel = pos - planet_center
    ra = planet_radius + atmosphere_height

    if clamp_to_shell:
        # the LUT's clamped height_ratio: samples outside [R, R+H] behave as
        # if radially projected onto the shell
        r = torch.sqrt(rel.x * rel.x + rel.y * rel.y + rel.z * rel.z)
        r_clamped = clamp(r, planet_radius, ra)
        scale = r_clamped / torch.clamp(r, min=1e-20)
        rel = rel * scale

    b = rel.x * direction.x + rel.y * direction.y + rel.z * direction.z
    c0 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z
    q2 = torch.clamp(c0 - b * b, min=0.0)

    ha = ra * ra - q2
    shell_hit = ha > 0.0
    sq_a = torch.sqrt(torch.where(shell_hit, torch.clamp(ha, min=1e-12), 1.0))
    sq_a = torch.where(shell_hit, sq_a, 0.0)
    s = torch.clamp(-b - sq_a, min=0.0)
    e = torch.clamp(-b + sq_a, min=0.0)
    e = torch.where(shell_hit, e, s)

    hg = planet_radius * planet_radius - q2
    ground_hit = hg > 0.0
    sq_g = torch.sqrt(torch.where(ground_hit, torch.clamp(hg, min=1e-12), 1.0))
    sq_g = torch.where(ground_hit, sq_g, 0.0)
    g0 = torch.where(ground_hit, -b - sq_g, e)
    g1 = torch.where(ground_hit, -b + sq_g, e)
    g0 = clamp(g0, s, e)
    g1 = clamp(g1, s, e)

    dens2 = density * density
    nodes, weights = gauss_legendre_01(quad_points)
    inv_h = 1.0 / atmosphere_height

    def smooth_segment(a0, a1):
        seg = a1 - a0
        acc = torch.zeros_like(seg)
        for xn, wn in zip(nodes, weights):
            t = a0 + seg * xn
            x = t + b
            r = torch.sqrt(x * x + q2)
            y = 1.0 - torch.clamp((r - planet_radius) * inv_h, 0.0, 1.0)
            acc = acc + wn * (y * y * y)
        return acc * seg * dens2

    below = (g1 - g0) * dens2
    return smooth_segment(s, g0) + smooth_segment(g1, e) + below
