"""v2 scattering atmosphere: wavelength-dependent single scattering
(``atmosphere_funcs_v2.gdshaderinc:32-101``).  The sun optical depth is
analytic (``od_mode="analytic"``) or read from the baked LUT
(``od_mode="lut"``, ``get_baked_optical_depth``).

Counterpart of ``godot_atmosphere_shader_tpu/ops/atmosphere_v2.py``.
"""

from __future__ import annotations

import torch

from .vecmath import Vec3, pow4
from .density import atmosphere_density
from .optical_depth import get_baked_optical_depth, optical_depth_analytic


def scattering_coefficients(params):
    """``pow4(400/λ) · strength`` per channel (:47-51)."""
    w = params.scattering_wavelengths
    s = params.scattering_strength
    return tuple(pow4(400.0 / w[i]) * s for i in range(3))


def compute_atmosphere_v2(ray_origin: Vec3, ray_dir: Vec3, planet_center: Vec3,
                          t_begin, t_end, sun_dir: Vec3, jitter,
                          params, steps: int, od_mode: str = "analytic", lut=None):
    """Returns ``(rgb: Vec3, alpha)`` of the v2 march over ``[t_begin,
    t_end]`` (alpha dithered by ``jitter``, capped at 0.99).  ``lut``: the
    baked optical-depth LUT that ``od_mode="lut"`` samples."""
    if od_mode == "lut" and lut is None:
        raise ValueError("od_mode='lut' requires a baked LUT")
    if od_mode not in ("lut", "analytic"):
        raise ValueError(f"unknown od_mode {od_mode!r}")
    r = params.planet_radius
    h = params.atmosphere_height
    dens_param = params.density
    cr, cg, cb = scattering_coefficients(params)

    step_len = (t_end - t_begin) / float(steps)
    pos = ray_origin + ray_dir * t_begin
    zero = torch.zeros_like(t_begin)
    total_r = total_g = total_b = view_od = alpha = zero

    for _ in range(steps):
        if od_mode == "lut":
            sun_od = get_baked_optical_depth(pos, sun_dir, planet_center, lut, r, h)
        else:
            sun_od = optical_depth_analytic(pos, sun_dir, planet_center, r, h, dens_param)
        rel = pos - planet_center
        height = torch.sqrt(rel.x * rel.x + rel.y * rel.y + rel.z * rel.z)
        # the second ·density: extinction ∝ density², as in the reference
        local_density = atmosphere_density(height, r, h, dens_param) * dens_param
        view_od = view_od + local_density * step_len

        od = sun_od + view_od
        total_r = total_r + local_density * step_len * torch.exp(-od * cr) * cr
        total_g = total_g + local_density * step_len * torch.exp(-od * cg) * cg
        total_b = total_b + local_density * step_len * torch.exp(-od * cb) * cb

        vtransmittance = torch.exp(-local_density * step_len)
        alpha = alpha + (1.0 - vtransmittance) * (1.0 - alpha)
        pos = pos + ray_dir * step_len

    amb = params.atmosphere_ambient_color
    total_r = torch.clamp(total_r + amb[0], 0.0, 1.0)
    total_g = torch.clamp(total_g + amb[1], 0.0, 1.0)
    total_b = torch.clamp(total_b + amb[2], 0.0, 1.0)

    # de-banding dither; the 0.99 cap avoids noisy HDR sunsets (:93-96)
    alpha = torch.clamp(alpha + jitter * 0.02, 0.0, 0.99)

    mod = params.atmosphere_modulate
    return Vec3(total_r * mod[0], total_g * mod[1], total_b * mod[2]), alpha
