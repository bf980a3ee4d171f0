"""Atmosphere density profile (``atmosphere_common.gdshaderinc:12-24``): a
cubic falloff ``(1 − h)³ · density`` of the normalized height, clamped to
the shell.  Counterpart of ``godot_atmosphere_shader_tpu/ops/density.py``."""

from __future__ import annotations

from .vecmath import saturate


def atmosphere_density(dist_from_center, planet_radius, atmosphere_height, density):
    """Density at a distance from the planet center (``u_density`` is applied
    once here; the callers multiply by it again, as the reference does)."""
    sd = dist_from_center - planet_radius
    h = saturate(sd / atmosphere_height)
    y = 1.0 - h
    return y * y * y * density
