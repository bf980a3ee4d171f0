"""v1 "lite" atmosphere: the non-physical 4-color model
(``atmosphere_funcs_v1.gdshaderinc``).

Counterpart of ``godot_atmosphere_shader_tpu/ops/atmosphere_v1.py``.  A
fixed-step march accumulates ``factor *= 1 − density·dt`` and a squared
sun-facing term; the day and night color pairs are mixed by the resulting
atmosphere and day factors.
"""

from __future__ import annotations

import torch

from .vecmath import Vec3, lerp, saturate
from .density import atmosphere_density


def atmo_factor_v1(ray_origin: Vec3, ray_dir: Vec3, planet_center: Vec3,
                   t_begin, t_end, sun_dir: Vec3, planet_radius,
                   atmosphere_height, density, steps: int):
    """``get_atmo_factor`` (:15-45): returns ``(atmo_factor, light_factor)``."""
    inv_steps = 1.0 / float(steps)
    step_len = (t_end - t_begin) * inv_steps
    pos = ray_origin + ray_dir * t_begin
    factor = torch.ones_like(t_begin)
    light_sum = torch.zeros_like(t_begin)
    for _ in range(steps):
        rel = pos - planet_center
        d = torch.sqrt(rel.x * rel.x + rel.y * rel.y + rel.z * rel.z)
        inv_d = 1.0 / d
        up = rel * inv_d
        dens = atmosphere_density(d, planet_radius, atmosphere_height, density)
        light = saturate(1.2 * (sun_dir.x * up.x + sun_dir.y * up.y + sun_dir.z * up.z)
                         + 0.5)
        light = light * light
        light_sum = light_sum + light * inv_steps
        factor = factor * (1.0 - dens * step_len)
        pos = pos + ray_dir * step_len
    return 1.0 - factor, light_sum


def compute_atmosphere_v1(ray_origin: Vec3, ray_dir: Vec3, planet_center: Vec3,
                          t_begin, t_end, sun_dir: Vec3, params, steps: int):
    """``compute_atmosphere`` (:48-63): returns ``(rgb: Vec3, alpha)``.
    ``params`` needs the radii, ``density``, the linear ``day_color0/1`` and
    ``night_color0/1`` and ``day_night_transition_scale``."""
    atmo_factor, light_factor = atmo_factor_v1(
        ray_origin, ray_dir, planet_center, t_begin, t_end, sun_dir,
        params.planet_radius, params.atmosphere_height, params.density, steps)
    n0, n1 = params.night_color0, params.night_color1
    d0, d1 = params.day_color0, params.day_color1
    night = Vec3(*(lerp(n0[c], n1[c], atmo_factor) for c in range(3)))
    day = Vec3(*(lerp(d0[c], d1[c], atmo_factor) for c in range(3)))
    day_factor = saturate(light_factor * params.day_night_transition_scale)
    col = Vec3(*(lerp(a, b, day_factor) for a, b in zip(night, day)))
    return col, saturate(atmo_factor)
