"""Volumetric cloud layer between two spheres (``cloud_funcs.gdshaderinc``).

Counterpart of ``godot_atmosphere_shader_tpu/ops/clouds.py``: coverage per
step or sampled at ``K + 1`` ray knots (optionally every ``coverage_lod``
coarse rows) and interpolated per step, the shape field per step or likewise
at ``cloud_shape_knots + 1`` knots, and at full quality
(``clouds_always_low_quality=False``) the detail field (the shape field at
``pos·15 + time·0.01``) per step or at its own knots; cheap or sun-marched
(``raymarched_lighting``) light, the conservative density-bound cull, and
the vertical cloud LOD.
The per-step march is a Python loop over whole pixel planes; the CUDA
megakernel runs the same arithmetic per coarse pixel.  Knot fields are
evaluated ``knot_group`` knots per field call, which matters only for the
pyramid samplers, whose result depends on the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .camera import transform_dir, transform_point
from .vecmath import (Vec3, blend_colors, length, lerp, maximum,
                             minimum, pow2, ray_sphere, saturate, smoothstep)


@dataclasses.dataclass
class CloudSettings:
    """``CloudSettings`` struct (:18-23)."""

    bottom_height: torch.Tensor  # absolute radius of the layer bottom
    top_height: torch.Tensor  # absolute radius of the layer top
    density_scale: torch.Tensor
    ground_height: torch.Tensor  # planet radius


def cloud_settings(params) -> CloudSettings:
    return CloudSettings(
        bottom_height=params.planet_radius + params.cloud_bottom * params.atmosphere_height,
        top_height=params.planet_radius + params.cloud_top * params.atmosphere_height,
        density_scale=params.cloud_density_scale,
        ground_height=params.planet_radius,
    )


def height_curve(x):
    """Parabolic vertical profile (:25-29)."""
    return 1.0 - pow2(2.0 * x - 1.0)


def raw_coverage(pos: Vec3, params, coverage_fn: Callable):
    """Coverage at a model-space position: the animated xz rotation (:43-45)
    followed by the field lookup."""
    rot = params.cloud_coverage_rotation
    cov_x = rot[0, 0] * pos.x + rot[0, 1] * pos.z
    cov_z = rot[1, 0] * pos.x + rot[1, 1] * pos.z
    return coverage_fn(Vec3(cov_x, pos.y, cov_z))


def detail_position(pos: Vec3, time) -> Vec3:
    """Where the detail field samples the shape field: ``pos·15 +
    time·0.01`` (:60)."""
    t = time * 0.01
    return pos * 15.0 + Vec3(t, t, t)


def get_density_full(pos: Vec3, time, settings: CloudSettings, params,
                     shape_fn: Callable, coverage_fn: Callable, low: bool,
                     always_low: bool, coverage_value=None, pos_len=None,
                     shape_value=None, detail_value=None):
    """``get_density_full`` (:31-68); ``pos`` is in planet model space.
    Low quality (``low`` or ``always_low``) takes detail = 0.5, full quality
    the detail field: ``detail_value`` (interpolated from its knots) or the
    shape field at :func:`detail_position`.  ``coverage_value``/
    ``shape_value`` are raw field values interpolated from the ray knots."""
    if always_low:
        low = True
    if pos_len is None:
        pos_len = length(pos)
    h = pos_len - settings.bottom_height
    height_ratio = h / (settings.top_height - settings.bottom_height)
    hc = torch.clamp(height_curve(height_ratio), min=0.0)

    coverage = (coverage_value if coverage_value is not None
                else raw_coverage(pos, params, coverage_fn))
    coverage = coverage - 0.25 * height_ratio + params.cloud_coverage_bias

    shape_raw = (shape_value if shape_value is not None
                 else shape_fn(pos * params.cloud_shape_scale))
    shape = lerp(0.5, shape_raw, params.cloud_shape_factor)
    if low:
        detail = 0.5
    elif detail_value is not None:
        detail = detail_value
    else:
        detail = shape_fn(detail_position(pos, time))

    # u_cloud_shape_invert is a float switch in the shader (:57-59)
    shape = torch.where(params.cloud_shape_invert == 1.0, 1.0 - shape, shape)

    density = (shape - 0.2 * detail + lerp(-1.2, 1.5, coverage)) * hc
    density = density * 50.0 - 20.0
    return saturate(density)


def get_planet_shadow(pos: Vec3, sun_dir: Vec3, pos_len=None):
    """Night-side dimming (:78-90)."""
    if pos_len is None:
        pos_len = length(pos)
    inv = 1.0 / pos_len
    d = -(pos.x * sun_dir.x + pos.y * sun_dir.y + pos.z * sun_dir.z) * inv
    return smoothstep(-0.3, 0.3, d)


def get_light_cheap(pos: Vec3, ray_dir: Vec3, sun_dir: Vec3, alpha,
                    settings: CloudSettings, pos_len=None):
    """(:92-102) — height-ratio ambient plus a pow16 sun glow through thin
    cloud, only looking toward the sun."""
    if pos_len is None:
        pos_len = length(pos)
    h = pos_len - settings.bottom_height
    height_ratio = h / (settings.top_height - settings.bottom_height)
    dp = ray_dir.x * sun_dir.x + ray_dir.y * sun_dir.y + ray_dir.z * sun_dir.z
    dp2 = dp * dp
    dp4 = dp2 * dp2
    dp8 = dp4 * dp4
    glow = torch.where(dp > 0.0, dp8 * dp8, 0.0)
    return height_ratio + glow * (1.0 - alpha)


#: the sun march of raymarched lighting: steps, and its reach in layers
SUN_STEPS = 6
SUN_REACH = 0.15


def get_light_raymarched(pos0: Vec3, sun_dir: Vec3, jitter, alpha0, time,
                         settings: CloudSettings, params, shape_fn: Callable,
                         coverage_fn: Callable, always_low: bool,
                         coverage_value=None, shape_value=None, detail_value=None):
    """The 6-step sun march (:104-151): step ``i`` samples the density at
    ``pos0 + sun_dir · (i · len_i)`` with ``len_i = (0.15 · layer / 6) ·
    1.2^i`` (the step's own length, not a cumulative sum), and the light is
    ``lerp(1, 0.2 · height_ratio(pos0), alpha)`` of the accumulated alpha.
    ``coverage_value``, ``shape_value`` and ``detail_value`` (the march
    step's interpolated knots) are reused by every sun sample where given;
    otherwise each field is evaluated at each sun sample.  At full quality
    a pixel whose march alpha ``alpha0`` is below 0.3 takes the full
    density, the others the low one (both computed, then selected).
    ``jitter`` is unused, as in the reference."""
    layer = settings.top_height - settings.bottom_height
    reach = layer * SUN_REACH
    pos0_height_ratio = (length(pos0) - settings.bottom_height) / layer
    step_len = reach / float(SUN_STEPS)
    alpha = torch.zeros_like(alpha0)
    for i in range(SUN_STEPS):
        pos = pos0 + sun_dir * (float(i) * step_len)
        density = get_density_full(pos, time, settings, params, shape_fn, coverage_fn,
                                   True, always_low, coverage_value=coverage_value,
                                   shape_value=shape_value)
        if not always_low:
            full = get_density_full(pos, time, settings, params, shape_fn, coverage_fn,
                                    False, False, coverage_value=coverage_value,
                                    shape_value=shape_value, detail_value=detail_value)
            density = torch.where(alpha0 < 0.3, full, density)
        density = density * (step_len * settings.density_scale)
        transmittance = torch.exp(-density)
        alpha = alpha + (1.0 - transmittance) * (1.0 - alpha)
        step_len = step_len * 1.2
    return lerp(1.0, pos0_height_ratio * 0.2, alpha)


def get_light(pos: Vec3, ray_dir: Vec3, sun_dir: Vec3, jitter, alpha, time,
              settings: CloudSettings, params, shape_fn: Callable,
              coverage_fn: Callable, raymarched: bool, always_low: bool,
              pos_len=None, coverage_value=None, shape_value=None, detail_value=None):
    """(:153-167): the lighting model, then the planet shadow (× 0.002)."""
    if raymarched:
        light = get_light_raymarched(pos, sun_dir, jitter, alpha, time, settings, params,
                                     shape_fn, coverage_fn, always_low,
                                     coverage_value=coverage_value, shape_value=shape_value,
                                     detail_value=detail_value)
    else:
        light = get_light_cheap(pos, ray_dir, sun_dir, alpha, settings, pos_len=pos_len)
    return light * lerp(1.0, 0.002, get_planet_shadow(pos, sun_dir, pos_len=pos_len))


def march_distance_limit(ray_origin: Vec3, settings: CloudSettings):
    """The longest marched span (:181-204): a "space" and a "ground" budget
    blended by camera height, so the horizon does not peer through the
    layer from orbit.  A per-frame scalar (the ray origin is the camera)."""
    march_distance_space = 0.5 * torch.sqrt(torch.clamp(
        1.0 - pow2(settings.ground_height / settings.top_height), min=0.0)
    ) * settings.bottom_height
    march_distance_ground = 3.0 * march_distance_space
    return lerp(march_distance_ground, march_distance_space,
                smoothstep(settings.bottom_height, settings.top_height * 1.05,
                           length(ray_origin)))


def clamp_march_distance(ray_origin: Vec3, t_begin, t_end,
                         settings: CloudSettings):
    """Clamp the marched span to :func:`march_distance_limit`; idempotent."""
    return t_begin + minimum(t_end - t_begin,
                             march_distance_limit(ray_origin, settings))


def step_phase(i: int, steps: int) -> float:
    """``u01 = (i + 0.5) / steps`` of march step ``i``, in f32 as the march
    loop computes it."""
    return float((np.float32(i) + np.float32(0.5)) * np.float32(1.0 / steps))


def knot_weights(u01: float, n: int, dynamic: bool):
    """Per-step knot weights ``{k: w}`` at phase ``u01`` over ``n + 1``
    knots, in f32: the two live knots (``dynamic``) or the full hat sum."""
    u = np.float32(u01) * np.float32(n)
    if dynamic and n >= 2:
        i0 = np.float32(min(max(np.floor(u), np.float32(0.0)), np.float32(n - 1)))
        f = np.float32(u - i0)
        return {int(i0): float(np.float32(1.0) - f), int(i0) + 1: float(f)}
    return {k: float(np.maximum(np.float32(0.0),
                                np.float32(1.0) - np.abs(u - np.float32(k))))
            for k in range(n + 1)}


def interp_knots(knots, u01: float, dynamic: bool):
    """Interpolate a knot field at step phase ``u01`` ∈ [0, 1]."""
    weights = knot_weights(u01, len(knots) - 1, dynamic)
    out = None
    for k, w in weights.items():
        term = knots[k] * w
        out = term if out is None else out + term
    return out


def raymarch_cloud(ray_origin: Vec3, ray_dir: Vec3, t_begin, t_end, jitter,
                   sun_dir: Vec3, time, settings: CloudSettings, params,
                   shape_fn, coverage_fn, steps: int,
                   raymarched_lighting: bool, always_low: bool,
                   coverage_interp: bool = False, coverage_endpoints=None,
                   coverage_knots: int = 8, knot_dynamic: bool = False,
                   shape_endpoints=None, detail_endpoints=None):
    """``raymarch_cloud`` (:175-247).  Returns ``(total_light, alpha)``."""
    t_end = clamp_march_distance(ray_origin, t_begin, t_end, settings)
    step_len = (t_end - t_begin) * (1.0 / float(steps))
    start = ray_origin + ray_dir * (jitter * step_len) + ray_dir * t_begin

    knots = None
    if coverage_interp:
        if coverage_endpoints is not None:
            knots = coverage_endpoints
        else:
            K = max(int(coverage_knots), 1)
            knots = tuple(
                raw_coverage(ray_origin + ray_dir * lerp(t_begin, t_end, k / float(K)),
                             params, coverage_fn)
                for k in range(K + 1))

    prod = torch.ones_like(t_begin)
    total_transmittance = torch.ones_like(t_begin)
    total_light = torch.zeros_like(t_begin)
    for i in range(steps):
        pos = start + ray_dir * (float(i) * step_len)
        pos_len = length(pos)
        alpha = 1.0 - prod
        u01 = step_phase(i, steps)
        coverage_value = None
        if knots is not None:
            coverage_value = interp_knots(knots, u01, knot_dynamic)
        shape_value = detail_value = None
        if shape_endpoints is not None:
            shape_value = interp_knots(shape_endpoints, u01, knot_dynamic)
        if detail_endpoints is not None:
            detail_value = interp_knots(detail_endpoints, u01, knot_dynamic)
        light = get_light(pos, ray_dir, sun_dir, jitter, alpha, time, settings, params,
                          shape_fn, coverage_fn, raymarched_lighting, always_low,
                          pos_len=pos_len, coverage_value=coverage_value,
                          shape_value=shape_value, detail_value=detail_value)
        density = get_density_full(pos, time, settings, params, shape_fn,
                                   coverage_fn, False, always_low,
                                   coverage_value=coverage_value,
                                   pos_len=pos_len, shape_value=shape_value,
                                   detail_value=detail_value)
        density = density * settings.density_scale

        transmittance = torch.exp(-density * step_len)
        total_transmittance = torch.clamp(total_transmittance * transmittance,
                                          min=0.005)
        total_light = total_light + light * density * step_len * total_transmittance
        prod = prod * transmittance
    return total_light, 1.0 - prod


def _down_mean(x, group: int):
    """Mean over row groups of ``group`` rows, summed in row order."""
    h, w = x.shape
    g = x.reshape(h // group, group, w)
    acc = g[:, 0]
    for r in range(1, group):
        acc = acc + g[:, r]
    return acc / float(group)


def cull_bound(cov_knots, params, always_low: bool):
    """Conservative per-pixel bound on the march density: nonzero density
    needs ``(shape_max − detail + lerp(−1.2, 1.5, cov_max))·50 − 20 > 0``
    with ``shape ≤ 0.5 + 0.575·|factor|`` (also under invert), ``detail =
    0.5`` in low mode and ``height_curve ≤ 1`` (:537-574)."""
    shape_bound = 0.5 + 0.575 * params.cloud_shape_factor.abs()
    detail_term = 0.1 if always_low else 0.0
    cov_max = cov_knots[0]
    for cov_k in cov_knots[1:]:
        cov_max = torch.maximum(cov_max, cov_k)
    cov_max = cov_max + params.cloud_coverage_bias
    return (shape_bound - detail_term + lerp(-1.2, 1.5, cov_max)) * 50.0 - 20.0


def render_clouds(albedo: Vec3, alpha, planet_center: Vec3,
                  ray_origin: Vec3, ray_dir: Vec3, linear_depth,
                  world_to_model, sun_dir: Vec3, jitter, time, params,
                  shape_fn, coverage_fn, steps: int,
                  raymarched_lighting: bool, always_low: bool,
                  coverage_interp: bool = False, cull: bool = False,
                  return_raw: bool = False, coverage_knots: int = 8,
                  coverage_lod: int = 1, shape_interp: bool = False,
                  shape_knots: int = 16, knot_group: int = 1,
                  knot_dynamic: bool = False):
    """``render_clouds`` (:249-324) over whole pixel planes, in world space
    (converted to planet model space with ``world_to_model``).  Returns the
    blended ``(albedo, alpha)``, or ``(light, alpha, visible)`` raw."""
    settings = cloud_settings(params)

    top0, top1 = ray_sphere(planet_center, settings.top_height, ray_origin, ray_dir)
    hit_top = top0 != top1
    bot0, bot1 = ray_sphere(planet_center, settings.bottom_height, ray_origin,
                            ray_dir)
    t_begin = torch.clamp(top0, min=0.0)
    t_end = torch.minimum(top1, linear_depth)
    # occlusion early-outs (:273-278) as a mask
    visible = hit_top & (t_begin < linear_depth) & ((linear_depth > bot1)
                                                   | (bot0 > 0.0))

    ro_model = transform_point(world_to_model, ray_origin)
    rd_model = transform_dir(world_to_model, ray_dir)
    sd_model = transform_dir(world_to_model, sun_dir)

    # masked pixels march a degenerate [t_begin, t_begin] interval
    t_end_m = torch.where(visible, t_end, t_begin)
    t_end_m = clamp_march_distance(ro_model, t_begin, t_end_m, settings)

    # knot fields, all sampled at the same ray positions (:419-442)
    plan = []
    if coverage_interp:
        plan.append(("cov", lambda pos: raw_coverage(pos, params, coverage_fn),
                     max(int(coverage_knots), 1)))
    if shape_interp:
        plan.append(("shp", lambda pos: shape_fn(pos * params.cloud_shape_scale),
                     max(int(shape_knots), 1)))
        if not always_low:
            plan.append(("det", lambda pos: shape_fn(detail_position(pos, time)),
                         max(int(shape_knots), 1)))

    def eval_knots(field, K, rd, t0, t1):
        """``field`` at the K + 1 ray knots, ``knot_group`` knots' planes
        stacked into one field call (:444-471)."""
        pts = [ro_model + rd * lerp(t0, t1, k / float(K)) for k in range(K + 1)]
        G = max(int(knot_group), 1)
        if G <= 1:
            return tuple(field(p) for p in pts)
        out = []
        for g0 in range(0, K + 1, G):
            grp = pts[g0:g0 + G]
            vals = field(Vec3(*(torch.stack([getattr(p, c) for p in grp])
                                for c in "xyz")))
            out.extend(vals.unbind(0))
        return tuple(out)

    def compute_knots():
        if not plan:
            return {}
        rd, t0, t1 = rd_model, t_begin, t_end_m
        if coverage_lod > 1:
            # knots every `coverage_lod` rows, nearest-upsampled; the mean
            # model-space ray is NOT renormalized
            if t_begin.shape[0] % coverage_lod:
                raise ValueError(f"cloud_coverage_lod={coverage_lod} needs a "
                                 f"row count divisible by it "
                                 f"(got {t_begin.shape[0]})")
            rd = Vec3(*(_down_mean(c, coverage_lod) for c in rd_model))
            t0 = _down_mean(t_begin, coverage_lod)
            t1 = _down_mean(t_end_m, coverage_lod)
        out = {}
        for name, field, K in plan:
            knots = eval_knots(field, K, rd, t0, t1)
            if coverage_lod > 1:
                knots = tuple(torch.repeat_interleave(c, coverage_lod, dim=0)
                              for c in knots)
            out[name] = knots
        return out

    def march(knots):
        return raymarch_cloud(
            ro_model, rd_model, t_begin, t_end_m, jitter, sd_model, time,
            settings, params, shape_fn, coverage_fn, steps,
            raymarched_lighting, always_low, coverage_interp=coverage_interp,
            coverage_endpoints=knots.get("cov"), coverage_knots=coverage_knots,
            knot_dynamic=knot_dynamic, shape_endpoints=knots.get("shp"),
            detail_endpoints=knots.get("det"))

    zero = torch.zeros_like(t_begin)
    if not cull:
        cloud_light, cloud_alpha = march(compute_knots())
    elif not bool(visible.any()):
        cloud_light, cloud_alpha = zero, zero
    elif not coverage_interp:
        cloud_light, cloud_alpha = march(compute_knots())
    else:
        # the march only runs when some pixel can hold nonzero density; a
        # pixel whose bound is ≤ 0 marches to exact zeros either way
        knots = compute_knots()
        cull_mask = visible & (cull_bound(knots["cov"], params, always_low) > 0.0)
        if bool(cull_mask.any()):
            cloud_light, cloud_alpha = march(knots)
        else:
            cloud_light, cloud_alpha = zero, zero

    if return_raw:
        return cloud_light, cloud_alpha, visible
    return apply_cloud_blend(albedo, alpha, cloud_light, cloud_alpha, visible,
                             params.cloud_blend)


def render_clouds_lod(albedo: Vec3, alpha, planet_center: Vec3,
                      ray_origin: Vec3, ray_dir: Vec3, linear_depth,
                      world_to_model, sun_dir: Vec3, jitter, time, params,
                      shape_fn, coverage_fn, steps: int,
                      raymarched_lighting: bool, always_low: bool,
                      lod: int, coverage_interp: bool = False,
                      cull: bool = False, coverage_knots: int = 8,
                      coverage_lod: int = 1, shape_interp: bool = False,
                      shape_knots: int = 16, knot_group: int = 1,
                      knot_dynamic: bool = False):
    """Vertical cloud LOD: march once per ``lod``-row group, blend at full
    resolution.  Coarse inputs per group: the renormalized mean of the
    member rays, the min of their depths, the first row's jitter; light,
    alpha and visibility are nearest-upsampled."""
    h = albedo.x.shape[0]
    if h % lod:
        raise ValueError(f"cloud_lod={lod} needs row count divisible by it "
                         f"(got {h})")

    rdm = Vec3(*(_down_mean(c, lod) for c in ray_dir))
    inv = 1.0 / torch.sqrt(rdm.x * rdm.x + rdm.y * rdm.y + rdm.z * rdm.z)
    ray_dir_c = Vec3(rdm.x * inv, rdm.y * inv, rdm.z * inv)
    w = linear_depth.shape[-1]
    depth_c = linear_depth.reshape(h // lod, lod, w).amin(dim=1)
    jitter_c = jitter[::lod].contiguous()

    zero_c = torch.zeros_like(depth_c)
    light_c, alpha_c, visible_c = render_clouds(
        Vec3(zero_c, zero_c, zero_c), zero_c, planet_center, ray_origin,
        ray_dir_c, depth_c, world_to_model, sun_dir, jitter_c, time, params,
        shape_fn, coverage_fn, steps, raymarched_lighting, always_low,
        coverage_interp=coverage_interp, cull=cull, return_raw=True,
        coverage_knots=coverage_knots, coverage_lod=coverage_lod,
        shape_interp=shape_interp, shape_knots=shape_knots,
        knot_group=knot_group, knot_dynamic=knot_dynamic)

    def up(x):
        return torch.repeat_interleave(x, lod, dim=0)

    return apply_cloud_blend(albedo, alpha, up(light_c), up(alpha_c),
                             up(visible_c), params.cloud_blend)


def apply_cloud_blend(albedo: Vec3, alpha, cloud_light, cloud_alpha, visible,
                      cloud_blend):
    """Blend the cloud layer over the atmosphere (:296-321): premultiplied
    alpha and additive blending mixed by ``u_cloud_blend``; occluded pixels
    pass the atmosphere through."""
    cloud_albedo = Vec3(cloud_light, cloud_light, cloud_light)
    blended_rgb, blended_a = blend_colors(albedo, alpha, cloud_albedo, cloud_alpha)
    add_rgb = albedo + cloud_albedo * cloud_alpha
    add_a = maximum(alpha, cloud_alpha)

    cb = cloud_blend
    out_rgb = Vec3(lerp(blended_rgb.x, add_rgb.x, cb),
                   lerp(blended_rgb.y, add_rgb.y, cb),
                   lerp(blended_rgb.z, add_rgb.z, cb))
    out_a = lerp(blended_a, add_a, cb)
    return (Vec3(torch.where(visible, out_rgb.x, albedo.x),
                 torch.where(visible, out_rgb.y, albedo.y),
                 torch.where(visible, out_rgb.z, albedo.z)),
            torch.where(visible, out_a, alpha))
