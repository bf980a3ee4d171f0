"""Whole-frame atmosphere pass: the ``atmosphere_fragment`` analog
(``planet_atmosphere_main.gdshaderinc:106-197``) in world space.

Counterpart of ``godot_atmosphere_shader_tpu/render/atmosphere_pass.py``
(v1 or v2; :func:`atmosphere_pass` composites against an external nonlinear
depth buffer).  Cloud fields are procedural noise or baked textures sampled
exactly (trilinear shape texture, seamless coverage cubemap); the
megakernel's plain version passes its pyramid samplers in instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .atmosphere_v1 import compute_atmosphere_v1
from .atmosphere_v2 import compute_atmosphere_v2
from .clouds import render_clouds, render_clouds_lod
from .noise import sample_noise3
from .sampling import (extend_cubemap_borders, sample_cubemap_bilinear,
                            sample_cubemap_seamless, sample_trilinear_repeat)
from .camera import Camera, linear_depth_from_buffer, rigid_inverse, world_ray_dirs
from .vecmath import Vec3, lerp, normalize, ray_sphere
from .jitter import jitter_plane


def make_shape_fn(config, params):
    """Cloud shape field at the reference's 3D texture coordinates (model
    position × shape scale): procedural ``0.5 + 0.5·noise(p·scale)`` or the
    trilinear repeat-wrapped shape texture."""
    spec = config.cloud_shape_noise
    if spec is None:
        tex = params.cloud_shape_texture
        if tex is None:
            raise ValueError("clouds need cloud_shape_texture or a procedural spec")
        return lambda p: sample_trilinear_repeat(tex, p.x, p.y, p.z)
    sx, sy, sz = spec.scale

    def shape_fn(p: Vec3):
        return 0.5 + 0.5 * sample_noise3(spec.noise, p.x * sx, p.y * sy, p.z * sz)

    return shape_fn


def make_coverage_fn(config, params):
    """Coverage: the NoiseCubemap generator formula
    ``0.5 + 0.5·noise(normalize(p)·scale)`` evaluated directly, or the baked
    cubemap (seamless across faces with ``cubemap_seamless``)."""
    spec = config.cloud_coverage_noise
    if spec is None:
        faces = params.cloud_coverage_cubemap
        if faces is None:
            raise ValueError("clouds need cloud_coverage_cubemap or a procedural spec")
        if config.cubemap_seamless:
            faces_ext = extend_cubemap_borders(faces)
            return lambda p: sample_cubemap_seamless(faces_ext, p)
        return lambda p: sample_cubemap_bilinear(faces, p)
    sx, sy, sz = spec.scale

    def coverage_fn(p: Vec3):
        d = normalize(p)
        return 0.5 + 0.5 * sample_noise3(spec.noise, d.x * sx, d.y * sy, d.z * sz)

    return coverage_fn


def shade_atmosphere(params, config, ray_origin: Vec3, ray_dir: Vec3,
                     linear_depth: torch.Tensor, jitter: torch.Tensor,
                     planet_center: Vec3, shape_fn=None,
                     coverage_fn=None) -> Tuple[Vec3, torch.Tensor, torch.Tensor]:
    """Everything from the shell intersection (:144) on: returns
    ``(rgb, alpha, hit_mask)`` of one layer, clouds included.  ``shape_fn``
    and ``coverage_fn`` replace the config's field closures (the pyramid
    samplers); only then are knots evaluated ``texture_knot_group`` at a
    time, as the megakernel does."""
    if config.model not in ("v1", "v2"):
        raise ValueError(f"unknown atmosphere model {config.model!r}")
    atmosphere_radius = params.planet_radius + params.atmosphere_height
    rs0, rs1 = ray_sphere(planet_center, atmosphere_radius, ray_origin, ray_dir)
    hit = rs0 != rs1

    # keep missed pixels finite: a zero-length march at the camera
    t_begin = torch.where(hit, torch.clamp(rs0, min=0.0), 0.0)
    t_end = torch.where(hit, torch.clamp(rs1, min=0.0), 0.0)

    g0, g1 = ray_sphere(planet_center, params.planet_radius, ray_origin, ray_dir)
    gd = torch.where(g0 != g1, g0, 1e7)
    linear_depth = lerp(linear_depth, gd, params.sphere_depth_factor)
    t_end = torch.maximum(torch.minimum(t_end, linear_depth), t_begin)

    sp = params.sun_position
    sun_dir = normalize(Vec3(sp[0], sp[1], sp[2]) - planet_center)

    zero = torch.zeros_like(t_begin)
    if config.tile_cull and not bool(hit.any()):
        # no pixel reaches the shell: the integrators are skipped outright
        return Vec3(zero, zero, zero), zero, hit

    if config.model == "v1":
        rgb, alpha = compute_atmosphere_v1(
            ray_origin, ray_dir, planet_center, t_begin, t_end, sun_dir, params,
            config.atmosphere_steps)
    else:
        rgb, alpha = compute_atmosphere_v2(
            ray_origin, ray_dir, planet_center, t_begin, t_end, sun_dir, jitter,
            params, config.atmosphere_steps, od_mode=config.od_mode,
            lut=params.optical_depth_lut)

    if config.clouds_enabled:
        overridden = shape_fn is not None or coverage_fn is not None
        kw = dict(coverage_interp=config.cloud_coverage_interp,
                  cull=config.tile_cull,
                  coverage_knots=config.cloud_coverage_knots,
                  coverage_lod=config.cloud_coverage_lod,
                  shape_interp=config.cloud_shape_interp,
                  shape_knots=config.cloud_shape_knots,
                  knot_group=config.texture_knot_group if overridden else 1,
                  knot_dynamic=config.knot_dynamic)
        args = (rgb, alpha, planet_center, ray_origin, ray_dir, linear_depth,
                params.world_to_model, sun_dir, jitter, params.time, params,
                shape_fn or make_shape_fn(config, params),
                coverage_fn or make_coverage_fn(config, params),
                config.cloud_steps, config.raymarched_lighting,
                config.clouds_always_low_quality)
        if config.cloud_lod > 1:
            rgb, alpha = render_clouds_lod(*args, config.cloud_lod, **kw)
        else:
            rgb, alpha = render_clouds(*args, **kw)
    return rgb, alpha, hit


def atmosphere_pass(params, config, camera: Camera, height: int, width: int,
                    depth: Optional[torch.Tensor] = None,
                    jitter: Optional[torch.Tensor] = None,
                    ray_dir: Optional[Vec3] = None,
                    linear_depth: Optional[torch.Tensor] = None
                    ) -> Tuple[Vec3, torch.Tensor, torch.Tensor]:
    """One atmosphere layer over a frame: ``(rgb, alpha, hit_mask)``, on
    the device of ``camera``.  ``depth``: an external nonlinear depth buffer
    (H, W) in the config's convention (reverse-Z by default), turned into
    the Euclidean distance the shader composites against
    (``linear_depth_from_buffer``); ``linear_depth`` is taken as it is
    instead (e.g. the analytic opaque pass's); without either every pixel
    is sky (1e7)."""
    device = camera.view_to_world.device
    params = params.resolve_frame_state()
    if ray_dir is None:
        ray_dir = world_ray_dirs(camera, height, width)
    if linear_depth is None:
        if depth is not None:
            linear_depth = linear_depth_from_buffer(camera, depth, height, width,
                                                    reverse_z=config.reverse_z)
        else:
            linear_depth = torch.full((height, width), 1e7, dtype=torch.float32,
                                      device=device)
    if jitter is None:
        jitter = jitter_plane(height, width, device=device)
    pc = rigid_inverse(params.world_to_model)[:3, 3]
    return shade_atmosphere(params, config, camera.position, ray_dir, linear_depth, jitter,
                            Vec3(pc[0], pc[1], pc[2]))


def composite_over(background: Vec3, rgb: Vec3, alpha, mask) -> Vec3:
    """Blend the atmosphere surface over the frame; missed-shell pixels
    ``discard`` (:191-196), leaving the background untouched."""
    a = torch.where(mask, alpha, 0.0)
    return Vec3(background.x * (1.0 - a) + rgb.x * a,
                background.y * (1.0 - a) + rgb.y * a,
                background.z * (1.0 - a) + rgb.z * a)
