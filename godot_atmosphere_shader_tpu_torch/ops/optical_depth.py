"""Analytic sun optical depth: the gather-free replacement of the 256×256
LUT.  Counterpart of ``godot_atmosphere_shader_tpu/ops/optical_depth.py``
(``optical_depth_analytic`` only; the LUT bake and ``od_mode="lut"`` are not
ported yet)."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.vecmath import Vec3, clamp


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
