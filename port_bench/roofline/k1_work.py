"""K1's work on one frame, reckoned from the frame's inputs in plain PyTorch:
what these inputs need, whatever implements it.

For a fused, fullscreen procedural layer (the ``megakernel_gen`` launch of
the demo's configurations) the units are:

* ``pixels``: every pixel (its ray, opaque pass, hits and blend);
* ``atmosphere``: the pixels whose ray meets the atmosphere's shell, each
  one v2 integration of ``atmosphere_steps`` steps;
* ``od_segments``: at each of those steps, the non-empty smooth segments of
  the sun's chord through the shell (split at the ground crossings): one
  where the chord misses the ground or the ground lies behind, two where it
  crosses the ground ahead;
* ``knot_groups``: with coverage knots, the coverage groups (``cloud_lod ·
  cloud_coverage_lod`` rows of one column) in which a coarse pixel sees the
  cloud layer; each evaluates ``coverage_knots + 1`` coverage knots;
* ``march``: the coarse pixels that see the cloud layer (the ray–shell and
  depth tests of the occlusion early-outs) and, with coverage knots, whose
  group's density bound (from its knots' largest coverage) is positive;
  each marches ``cloud_steps`` steps;
* ``coverage_evals`` / ``shape_evals``: the fields evaluated at every march
  step (coverage only without knots; shape at every step: no shape knots).

For a layer whose two fields are baked (the fixed ``megakernel_tex``
instance: coverage and shape knots, low quality, cheap light) the frame is
cut into the kernel's 32×128 tiles, the last ones padded with real rays
past the edge, and a tile evaluates its knots where any of its coarse
pixels sees the cloud layer:

* ``knot_groups``: every coverage group of such a tile, padding included;
* ``tex3d``, ``tex3d_floor``, ``latlong``, ``latlong_floor``: those groups'
  shape and coverage knots, sampled through the reference's pyramid
  samplers ``texture_knot_group`` knots a call, each call's tile taking the
  mode its batch chose (``record_batch_choices``): floor mode, or trilinear
  (bilinear) at a level;
* ``march``: the coarse pixels of the padded frame that see the cloud layer
  and whose group's bound (from its sampled coverage knots) is positive;
  no per-step field evaluation.

The geometry follows the frozen reference's plain path (``reference/``),
which the kernel is held to.  Other configurations raise: their units are
not reckoned here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..reference.atmosphere_pass import make_coverage_fn
from ..reference.camera import transform_dir, transform_point, world_ray_dirs
from ..reference.clouds import (_down_mean, clamp_march_distance, cloud_settings, cull_bound,
                                raw_coverage)
from ..reference.opaque import render_opaque
from ..reference.renderer import TILE_COLS, TILE_ROWS, planet_center
from ..reference.texsample import FLOOR, LANES, pyramid_samplers, record_batch_choices
from ..reference.vecmath import Vec3, lerp, normalize, ray_sphere
from . import counts
from .peaks import bound_ms

#: bytes a fused layer reads and writes once besides its planes: the 256²
#: float32 blue-noise tile
BLUE_NOISE_BYTES = 256 * 256 * 4
#: the fixed texture instance ``megakernel_tex<K, KS, G>``: its coverage and
#: shape knots and its coverage groups (G = cloud_lod · cloud_coverage_lod)
TEX_KNOTS, TEX_SHAPE_KNOTS, TEX_GROUPS = 8, 16, (4, 8)
_ZERO_SLOTS = ("tex3d", "tex3d_floor", "latlong", "latlong_floor", "sun_samples", "v1_atmosphere",
               "opaque_pixels", "sky", "sky_floor", "detail_evals", "shape_knots", "detail_knots")


def baked(config) -> bool:
    """Whether both of the layer's fields are baked textures."""
    return (config.cloud_shape_tex_meta is not None
            and config.cloud_coverage_tex_meta is not None)


def check_config(config):
    """The configurations whose units this module reckons."""
    procedural = (not config.cloud_shape_interp and config.cloud_shape_noise is not None
                  and config.cloud_coverage_noise is not None)
    fixed_tex = (baked(config) and config.cloud_shape_interp and config.cloud_coverage_interp
                 and config.cloud_coverage_knots == TEX_KNOTS
                 and config.cloud_shape_knots == TEX_SHAPE_KNOTS
                 and config.cloud_lod * config.cloud_coverage_lod in TEX_GROUPS)
    ok = (config.model == "v2" and config.od_mode == "analytic" and config.clouds_enabled
          and not config.raymarched_lighting and config.clouds_always_low_quality
          and (procedural or fixed_tex))
    if not ok:
        raise ValueError("K1's units are reckoned for a v2 layer with cheap light and low "
                         "quality only: procedural with no shape knots, or both fields baked "
                         "on the fixed texture instance")


def od_segments(pos: Vec3, sun_dir: Vec3, center: Vec3, radius, atmo_radius) -> torch.Tensor:
    """Per sample, the non-empty smooth segments (0, 1 or 2) of the sun's
    chord from ``pos`` through the shell, split at the ground crossings."""
    rel = pos - center
    r = torch.sqrt(rel.x * rel.x + rel.y * rel.y + rel.z * rel.z)
    r_cl = torch.clamp(torch.clamp(r, min=radius), max=atmo_radius)
    rel = rel * (r_cl / torch.clamp(r, min=1e-20))
    b = rel.x * sun_dir.x + rel.y * sun_dir.y + rel.z * sun_dir.z
    c0 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z
    q2 = torch.clamp(c0 - b * b, min=0.0)
    ha = atmo_radius * atmo_radius - q2
    shell = ha > 0.0
    sq_a = torch.where(shell, torch.sqrt(torch.clamp(ha, min=1e-12)), 0.0)
    s = torch.clamp(-b - sq_a, min=0.0)
    e = torch.where(shell, torch.clamp(-b + sq_a, min=0.0), s)
    hg = radius * radius - q2
    ground = hg > 0.0
    sq_g = torch.where(ground, torch.sqrt(torch.clamp(hg, min=1e-12)), 0.0)
    g0 = torch.minimum(torch.maximum(torch.where(ground, -b - sq_g, e), s), e)
    g1 = torch.minimum(torch.maximum(torch.where(ground, -b + sq_g, e), s), e)
    near, far = s < g0, g1 < e
    one = (g0 == g1) & ~(near & far)
    return torch.where(one, near.int() + far.int(), torch.full_like(s, 2, dtype=torch.int32))


def frame_work(scene, view_to_world, time_s: float, height: int, width: int) -> dict:
    """K1's units (``counts.work_ops``'s slots) for one frame of ``scene`` (a
    ``reference.scene.RefScene``) at this pose and scene time."""
    config = scene.config
    check_config(config)
    tex = baked(config)
    fs = scene.frame_state(time_s, np.asarray(view_to_world, np.float64)[:3, 3])
    params = dataclasses.replace(scene.params, frame_state=torch.as_tensor(
        fs, device=scene.device)).resolve_frame_state()
    cam = scene.cam(view_to_world)
    rows, cols = height, width
    if tex:  # the kernel's tiles, the last ones padded with real rays
        rows, cols = -(-height // TILE_ROWS) * TILE_ROWS, -(-width // TILE_COLS) * TILE_COLS
        rd = world_ray_dirs(cam, height, width, rows=rows, cols=cols)
    else:
        rd = world_ray_dirs(cam, height, width)
    ro = cam.position
    _, _, linear_depth = render_opaque(scene.opaque, cam, rows, cols,
                                       reverse_z=config.reverse_z, ray_dir=rd)
    pc = planet_center(params)
    radius = params.planet_radius
    atmo_radius = params.planet_radius + params.atmosphere_height
    rs0, rs1 = ray_sphere(pc, atmo_radius, ro, rd)
    hit = rs0 != rs1
    t_begin = torch.where(hit, torch.clamp(rs0, min=0.0), 0.0)
    t_end = torch.where(hit, torch.clamp(rs1, min=0.0), 0.0)
    g0, g1 = ray_sphere(pc, radius, ro, rd)
    depth = lerp(linear_depth, torch.where(g0 != g1, g0, 1e7), params.sphere_depth_factor)
    t_end = torch.maximum(torch.minimum(t_end, depth), t_begin)

    sp = params.sun_position
    sun_dir = normalize(Vec3(sp[0], sp[1], sp[2]) - pc)
    n = config.atmosphere_steps
    step = (t_end - t_begin) / float(n)
    segs = torch.zeros_like(t_begin, dtype=torch.int64)
    for i in range(n):
        pos = ro + rd * (t_begin + step * float(i))
        segs += od_segments(pos, sun_dir, pc, radius, atmo_radius)
    # the frame's own pixels integrate the atmosphere; the padding's are not counted
    segs = torch.where(hit, segs, 0)[:height, :width]

    # the coarse pixels: cloud_lod rows' renormalized mean ray, their least depth
    lod = config.cloud_lod
    if rows % lod:
        raise ValueError(f"cloud_lod={lod} must divide the rows ({rows})")
    rdm = Vec3(*(_down_mean(c, lod) for c in rd))
    inv = 1.0 / torch.sqrt(rdm.x * rdm.x + rdm.y * rdm.y + rdm.z * rdm.z)
    rd_c = Vec3(rdm.x * inv, rdm.y * inv, rdm.z * inv)
    depth_c = depth.reshape(rows // lod, lod, cols).amin(dim=1)
    settings = cloud_settings(params)
    top0, top1 = ray_sphere(pc, settings.top_height, ro, rd_c)
    bot0, bot1 = ray_sphere(pc, settings.bottom_height, ro, rd_c)
    tb_c = torch.clamp(top0, min=0.0)
    visible = (top0 != top1) & (tb_c < depth_c) & ((depth_c > bot1) | (bot0 > 0.0))

    marching = visible
    knot_groups = 0
    tex_units = {}
    if config.cloud_coverage_interp:
        group = config.cloud_coverage_lod
        if visible.shape[0] % group:
            raise ValueError(f"cloud_coverage_lod={group} must divide the coarse rows")
        w2m = params.world_to_model
        ro_m = transform_point(w2m, ro)
        rd_m = transform_dir(w2m, rd_c)
        te_c = torch.where(visible, torch.minimum(top1, depth_c), tb_c)
        te_c = clamp_march_distance(ro_m, tb_c, te_c, settings)
        g_rd = Vec3(*(_down_mean(c, group) for c in rd_m))
        g_t0, g_t1 = _down_mean(tb_c, group), _down_mean(te_c, group)
        if tex:
            knots, tex_units = baked_knots(config, params, scene.tex_data, visible, ro_m, g_rd,
                                           g_t0, g_t1)
        else:
            coverage_fn = make_coverage_fn(config, params)
            k = max(int(config.cloud_coverage_knots), 1)
            knots = tuple(raw_coverage(ro_m + g_rd * lerp(g_t0, g_t1, j / float(k)), params,
                                       coverage_fn) for j in range(k + 1))
            knot_groups = int(visible.reshape(-1, group, cols).any(dim=1).sum())
        forms = cull_bound(knots, params, config.clouds_always_low_quality) > 0.0
        marching = visible & torch.repeat_interleave(forms, group, dim=0)
    march = int(marching.sum())
    per_step = march * config.cloud_steps
    work = {"pixels": height * width, "atmosphere": int(hit[:height, :width].sum()),
            "od_segments": int(segs.sum()), "knot_groups": knot_groups, "march": march,
            "coverage_evals": 0 if config.cloud_coverage_interp else per_step,
            "shape_evals": 0 if config.cloud_shape_interp else per_step}
    work.update({k: 0 for k in _ZERO_SLOTS})
    work.update(tex_units)
    return work


def baked_knots(config, params, tex_data, visible, ro_m: Vec3, rd: Vec3, t0, t1) -> tuple:
    """The fixed texture instance's knots: each baked field's ``K + 1`` knots
    on the coverage groups' mean model-space rays ``ro_m + rd·lerp(t0, t1,
    k/K)``, sampled through the reference's pyramid samplers
    ``texture_knot_group`` knots a call as the plain path samples them, and
    the units of the tiles whose coarse pixels (``visible``) see the cloud
    layer: ``(coverage knots, {knot_groups, tex3d, tex3d_floor, latlong,
    latlong_floor})``, each sample in its call's batch (tile) mode."""
    lod = config.cloud_lod
    batch_rows = TILE_ROWS // (lod * config.cloud_coverage_lod)
    shape_fn, coverage_fn = pyramid_samplers(config, *tex_data, batch_rows)
    r, w = visible.shape
    tile_vis = visible.reshape(r * lod // TILE_ROWS, TILE_ROWS // lod, w // TILE_COLS,
                               TILE_COLS).any(dim=3).any(dim=1).reshape(-1)
    groups = batch_rows * LANES  # a tile's coverage groups, one thread each in the kernel
    units = {"knot_groups": int(tile_vis.sum()) * groups, "tex3d": 0, "tex3d_floor": 0, "latlong": 0,
             "latlong_floor": 0}
    fields = (("latlong", lambda p: raw_coverage(p, params, coverage_fn),
               config.cloud_coverage_knots),
              ("tex3d", lambda p: shape_fn(p * params.cloud_shape_scale),
               config.cloud_shape_knots))
    step = max(int(config.texture_knot_group), 1)
    knots = {}
    for slot, field, k in fields:
        k = max(int(k), 1)
        pts = [ro_m + rd * lerp(t0, t1, j / float(k)) for j in range(k + 1)]
        values = []
        with record_batch_choices() as calls:
            for j0 in range(0, k + 1, step):
                grp = pts[j0:j0 + step]
                values.extend(field(Vec3(*(torch.stack([getattr(p, c) for p in grp])
                                           for c in "xyz"))).unbind(0))
        for j0, (mode, _) in zip(range(0, k + 1, step), calls):
            per_tile = min(step, k + 1 - j0) * groups
            floor = mode == FLOOR
            units[slot] += per_tile * int((tile_vis & ~floor).sum())
            units[slot + "_floor"] += per_tile * int((tile_vis & floor).sum())
        knots[slot] = tuple(values)
    return knots["latlong"], units


def frame_bound_ms(work: dict, config, height: int, width: int) -> float:
    """The least time of a fused fullscreen layer with this work: its
    operations (``counts.work_ops``) against its planes written once (16 B a
    pixel), the blue-noise tile and a baked layer's pyramid tables read
    once."""
    ops = counts.work_ops(work, config)
    tables = sum(m.rows * LANES * 4 for m in (config.cloud_shape_tex_meta,
                                               config.cloud_coverage_tex_meta) if m is not None)
    return bound_ms(ops["shade"] + ops["blend"] + ops["clouds"], ops["int_ops"],
                    height * width * counts.BYTES_LAYER_PIXEL + BLUE_NOISE_BYTES + tables)
