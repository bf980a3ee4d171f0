"""The plain PyTorch frame: the opaque pass, then the atmosphere layers
(clouds included) composited far→near over it.

Counterpart of ``godot_atmosphere_shader_tpu/render/renderer.py::
render_frame_impl`` and of the Pallas megakernel's layer chain
(``ops/pallas/megakernel.py::_chain_layers``).  This is the plain version
the CUDA megakernel (``ops/kernels/megakernel.py``) is held against, and
the path CPU tensors take.

* :func:`render_frame` is one megakernel launch: one layer over the fused
  opaque pass or over a given background (a chained layer), on the whole
  frame or on a far-mode row band, or the opaque pass alone;
* :func:`render_scene` chains the layers as the megakernel does: layer 0
  fuses the opaque pass when it is fullscreen, otherwise the opaque-only
  pass runs first; each later layer composites over the carried color with
  the carried linear depth, on its band or the whole frame; alpha is the
  maximum over the layers;
* :func:`render_scene_band` is the same chain over one row shard of the
  frame (``render_scene_band_pallas``): layer 0 fuses the opaque pass and
  the sky over the shard's rows, the later layers composite over them.

Baked cloud textures come in two forms:

* exact sampling (no ``tex_data``): the textures of ``params`` are sampled
  per knot with the exact samplers, the twin of the JAX ``renderer="xla"``;
* pyramid sampling (a config carrying ``TexMeta``s and ``tex_data``): the
  megakernel's texture mode, whose samplers choose a mip level per batch —
  per 32×128 tile of the megakernel's grid and knot group.  The rows are
  then rendered on that grid, which starts at the band's first row, padded
  to whole tiles (the last tile's extra rows and columns are real rays past
  the edge, part of its batches), and cropped.

Procedural clouds whose LOD group (cloud_lod·cloud_coverage_lod rows) does
not divide the rows are padded and cropped the same way, to whole groups.

A panorama sky comes in the same two forms: sampled exactly
(``OpaqueScene.panorama`` without ``pano_data``, the twin of the JAX
``renderer="xla"``), or through the megakernel's three channel pyramids
(``pano_data``, ``pano_meta``), one level and mode per 32×128 tile of the
opaque pass's rays; the opaque pass then runs on that tile grid from the
frame's first row, padded and cropped in the same way.

:func:`render_flight_plain` is the counterpart of ``render_flight_xla``: K
frames of a flight by a host loop over :func:`render_scene` (every layer
fullscreen), optionally each resolved against the previous one by the
plain TAA resolve.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .params import AtmosphereParams, VariantConfig
from . import taa as taa_mod
from .camera import Camera, rigid_inverse, world_ray_dirs
from .vecmath import Vec3
from .atmosphere_pass import composite_over, shade_atmosphere
from .jitter import apply_temporal_offset, jitter_plane, temporal_offset
from .opaque import OpaqueScene, render_opaque
from .texsample import pyramid_samplers


def planet_center(params: AtmosphereParams) -> Vec3:
    """World-space planet center: the translation of ``model → world``."""
    pc = rigid_inverse(params.world_to_model)[:3, 3]
    return Vec3(pc[0], pc[1], pc[2])


#: the megakernel's tile: one batch of the pyramid samplers per knot group
TILE_ROWS, TILE_COLS = 32, 128
#: linear depth of a pixel without opaque geometry (sky)
SKY_DEPTH = 1e7


def shared_reverse_z(configs) -> bool:
    """The depth convention of the one opaque pass: Godot's REVERSE_Z is
    engine-global, so layers that disagree on it are an error
    (``render/renderer.py::shared_reverse_z``)."""
    if not configs:
        return True
    rz = configs[0].reverse_z
    if any(c.reverse_z != rz for c in configs):
        raise ValueError("all atmosphere layers must share one reverse_z "
                         "depth convention (it is engine-global in Godot)")
    return rz


def opaque_only_config(config: VariantConfig) -> VariantConfig:
    """The neutral config of the opaque-only pass (``megakernel.py:807-809``)."""
    return dataclasses.replace(config, clouds_enabled=False, cloud_shape_tex_meta=None,
                               cloud_coverage_tex_meta=None, cloud_lod=1)


def _pad(x: torch.Tensor, rows: int, cols: int, value: float) -> torch.Tensor:
    """``x`` (r, c, ...) padded with ``value`` to ``rows × cols``."""
    if x.shape[0] == rows and x.shape[1] == cols:
        return x
    out = torch.full((rows, cols) + tuple(x.shape[2:]), value, dtype=x.dtype, device=x.device)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def render_frame(params: AtmosphereParams, config: VariantConfig,
                 camera: Camera, opaque: Optional[OpaqueScene],
                 height: int, width: int, tex_data=None, background=None,
                 row0: int = 0, rows: Optional[int] = None,
                 with_atmosphere: bool = True, pano_data=None, pano_meta=None) -> dict:
    """One layer over rows ``[row0, row0 + rows)`` of a ``height × width``
    frame (default: all of it), as one megakernel launch renders it.  Given
    sequences of params and configs (the layers far to near), the JAX
    package's ``render_frame`` instead: every layer fullscreen over the
    opaque pass, ``{"color", "alpha"}`` and, with an opaque scene, its
    nonlinear ``depth``.

    Returns ``color`` ``(rows, W, 3)``, ``alpha`` ``(rows, W)``,
    ``linear_depth`` ``(rows, W)`` (the opaque pass's, before the
    sphere-depth blend; 1e7 for sky) and, with an opaque pass, the
    nonlinear ``depth`` buffer — on the device of ``camera``.
    ``background``: ``(color (rows, W, 3), linear_depth (rows, W))`` of the
    layers below, which replace the opaque pass (a chained layer; the
    returned alpha is this layer's).  ``with_atmosphere=False``: the
    opaque-only pass (background color, alpha 0, linear depth).
    ``tex_data`` is the ``(shape, coverage)`` pyramid tables of a config
    with ``TexMeta``s (``None`` for a procedural field beside a baked
    one); ``pano_data``/``pano_meta`` the panorama sky's (r, g, b) pyramid
    tables and their meta, sampled by the opaque pass (without them a
    panorama is sampled exactly)."""
    if not isinstance(params, AtmosphereParams):
        # the JAX package's render_frame(atmospheres, configs, ...): the
        # layers far to near, each fullscreen; color, alpha and the opaque
        # pass's nonlinear depth
        layers = render_scene(tuple(params), tuple(config), camera, opaque, height, width)
        out = {"color": layers["color"], "alpha": layers["alpha"]}
        if opaque is not None:
            out["depth"] = render_opaque(opaque, camera, height, width,
                                         reverse_z=shared_reverse_z(config))[1]
        return out
    device = camera.view_to_world.device
    params = params.resolve_frame_state()
    rows = height - row0 if rows is None else rows
    if row0 < 0 or rows < 1 or row0 + rows > height:
        raise ValueError(f"rows [{row0}, {row0 + rows}) outside a {height}-row frame")
    shape_fn = coverage_fn = None
    grid_rows, cols = rows, width
    metas = (config.cloud_shape_tex_meta, config.cloud_coverage_tex_meta)
    if with_atmosphere and any(m is not None for m in metas):
        if tex_data is None or len(tex_data) != 2 or any(
                (m is None) != (t is None) for m, t in zip(metas, tex_data)):
            raise ValueError("pyramid sampling needs the (shape, coverage) tables of "
                             "the fields with TexMetas, None for the others")
        group = config.cloud_lod * max(config.cloud_coverage_lod, 1)
        if TILE_ROWS % group:
            raise ValueError(f"cloud_lod·cloud_coverage_lod = {group} must "
                             f"divide the tile height {TILE_ROWS}")
        grid_rows = -(-rows // TILE_ROWS) * TILE_ROWS
        cols = -(-width // TILE_COLS) * TILE_COLS
        shape_fn, coverage_fn = pyramid_samplers(config, *tex_data, TILE_ROWS // group)
    sky_fn = None
    if pano_data is not None and background is None and opaque is not None:
        grid_rows = -(-rows // TILE_ROWS) * TILE_ROWS
        cols = -(-width // TILE_COLS) * TILE_COLS

        raise ValueError("the frozen reference renders no panorama pyramids")
    group = config.cloud_lod * config.cloud_coverage_lod if config.clouds_enabled else 1
    if with_atmosphere and grid_rows == rows and group >= 1 and rows % group:
        # a partial last LOD group is rendered whole: its rows past the band
        # are real rays, as in the TPU kernel's padded last tile
        grid_rows = -(-rows // group) * group
    ray_dir = world_ray_dirs(camera, height, width, rows=grid_rows, cols=cols, row0=row0)
    depth = None
    if background is not None:
        # rows and columns past the band or the frame: no geometry
        bg_color = _pad(background[0], grid_rows, cols, 0.0)
        bg = Vec3(bg_color[..., 0], bg_color[..., 1], bg_color[..., 2])
        linear_depth = _pad(background[1], grid_rows, cols, SKY_DEPTH)
    elif opaque is not None:
        bg, depth, linear_depth = render_opaque(
            opaque, camera, grid_rows, cols, reverse_z=config.reverse_z,
            ray_dir=ray_dir, sky_fn=sky_fn)
    else:
        bg = Vec3(*(torch.zeros((grid_rows, cols), device=device)
                    for _ in range(3)))
        linear_depth = torch.full((grid_rows, cols), SKY_DEPTH, device=device)

    if with_atmosphere:
        jitter = jitter_plane(grid_rows, cols, device=device, row0=row0)
        if config.temporal_jitter:
            # golden-ratio offset keyed on scene time: successive frames of a
            # flight get decorrelated jitter (megakernel.py:385-390)
            jitter = apply_temporal_offset(jitter, temporal_offset(float(params.time)))
        rgb, alpha, mask = shade_atmosphere(params, config, camera.position,
                                            ray_dir, linear_depth, jitter,
                                            planet_center(params), shape_fn=shape_fn,
                                            coverage_fn=coverage_fn)
        color = composite_over(bg, rgb, alpha, mask)
        alpha = torch.clamp(torch.where(mask, alpha, 0.0), min=0.0)
    else:
        color, alpha = bg, torch.zeros_like(linear_depth)
    out = {"color": torch.stack([color.x, color.y, color.z], dim=-1),
           "alpha": alpha, "linear_depth": linear_depth}
    if depth is not None:
        out["depth"] = depth
    return {k: v[:rows, :width] for k, v in out.items()}


def render_scene(params_seq, configs, camera: Camera, opaque: Optional[OpaqueScene],
                 height: int, width: int, tex_data=None, bands=None,
                 band_rows=None, pano_data=None, pano_meta=None) -> dict:
    """The far→near layer chain (``megakernel.py:770-849``): ``{"color":
    (H, W, 3), "alpha": (H, W), "linear_depth": (H, W)}``.

    ``params_seq``/``configs``: the layers, far to near; ``tex_data``: per
    layer, its pyramid tables or ``None``; ``bands``: per layer ``None``
    (fullscreen) or its band height, ``band_rows`` its first row.  Layer 0
    fuses the opaque pass when it is fullscreen; otherwise the opaque-only
    pass renders the base frame.  Every later layer composites over the
    carried color with the carried linear depth (the opaque pass's), on its
    rows; alpha is the maximum over the layers.  ``pano_data``/``pano_meta``:
    the panorama sky's pyramids, sampled by whichever pass runs the opaque
    pass."""
    n = len(configs)
    shared_reverse_z(configs)
    tex = tex_data or (None,) * n
    bands = bands or (None,) * n
    if bands[0] is None:
        out = render_frame(params_seq[0], configs[0], camera, opaque, height, width,
                           tex_data=tex[0], pano_data=pano_data, pano_meta=pano_meta)
        start = 1
    else:
        out = render_frame(params_seq[0], opaque_only_config(configs[0]), camera, opaque,
                           height, width, with_atmosphere=False, pano_data=pano_data,
                           pano_meta=pano_meta)
        start = 0
    color, alpha, linear_depth = out["color"], out["alpha"], out["linear_depth"]
    for i in range(start, n):
        r0 = 0 if bands[i] is None else int(band_rows[i])
        r1 = height if bands[i] is None else r0 + int(bands[i])
        res = render_frame(params_seq[i], configs[i], camera, None, height, width,
                           tex_data=tex[i], background=(color[r0:r1], linear_depth[r0:r1]),
                           row0=r0, rows=r1 - r0)
        color = torch.cat([color[:r0], res["color"], color[r1:]])
        alpha = torch.cat([alpha[:r0], torch.maximum(alpha[r0:r1], res["alpha"]), alpha[r1:]])
    return {"color": color, "alpha": alpha, "linear_depth": linear_depth}


def render_scene_band(params_seq, configs, camera: Camera, opaque: Optional[OpaqueScene],
                      height: int, width: int, row0: int, rows: int, tex_data=None,
                      pano_data=None, pano_meta=None) -> dict:
    """Rows ``[row0, row0 + rows)`` of the far→near layer chain, a row
    shard's share of the frame (``megakernel.py:686-737``): ``{"color":
    (rows, W, 3), "alpha": (rows, W), "linear_depth": (rows, W)}``.

    Layer 0 fuses the opaque pass (and the panorama sky, ``pano_data``/
    ``pano_meta``) over the band; every later layer composites over the
    band's color with the carried linear depth (the opaque pass's).  There
    is no opaque-only pass and no per-layer far band: the shard split takes
    their place.  Alpha is the maximum over the layers."""
    n = len(configs)
    shared_reverse_z(configs)
    tex = tex_data or (None,) * n
    out = render_frame(params_seq[0], configs[0], camera, opaque, height, width,
                       tex_data=tex[0], row0=row0, rows=rows, pano_data=pano_data,
                       pano_meta=pano_meta)
    color, alpha, linear_depth = out["color"], out["alpha"], out["linear_depth"]
    for i in range(1, n):
        res = render_frame(params_seq[i], configs[i], camera, None, height, width,
                           tex_data=tex[i], background=(color, linear_depth), row0=row0,
                           rows=rows)
        color, alpha = res["color"], torch.maximum(alpha, res["alpha"])
    return {"color": color, "alpha": alpha, "linear_depth": linear_depth}


def render_flight_plain(params_seq, fs_stacks, configs, camera: Camera,
                        opaque: Optional[OpaqueScene], height: int, width: int,
                        cam_stack=None, tex_data=None,
                        taa: Optional[taa_mod.TaaSettings] = None, pano_data=None,
                        pano_meta=None) -> dict:
    """K frames of a flight on the device of ``camera``: ``{"color":
    (K, H, W, 3), "alpha": (K, H, W)}``.  ``params_seq``/``configs``: the
    layers, far to near; ``fs_stacks``: per layer, (K, 24) host rows of
    packed frame state; ``cam_stack``: optional (K, 4, 4) host
    ``view_to_world`` transforms (default: ``camera``'s).  Every layer
    renders fullscreen (no bands in a flight).  With ``taa``, each frame
    (rendered with the configs as given: the TAA flight forces
    ``temporal_jitter``) is resolved against the previous resolved frame,
    with the chain's linear depth; frame 0 against zero history at depth
    1e7 with blend 1.0.  ``pano_data``/``pano_meta``: the panorama sky's
    pyramids, as in :func:`render_scene`."""
    device = camera.view_to_world.device
    fs_stacks = [np.asarray(fs, np.float32) for fs in fs_stacks]
    k = fs_stacks[0].shape[0]
    if cam_stack is None:
        vtw = camera.view_to_world.detach().cpu().numpy()
        cam_stack = np.broadcast_to(vtw, (k, 4, 4))
    f32 = dict(dtype=torch.float32, device=device)
    if taa is not None:
        resolves = taa_mod.flight_constants(camera, cam_stack, taa, height, width)
        history = torch.zeros((height, width, 3), **f32)
        history_depth = torch.full((height, width), taa_mod.DEPTH_CLAMP, **f32)
    colors, alphas = [], []
    for i, vtw in enumerate(cam_stack):
        ps = [dataclasses.replace(p, frame_state=torch.as_tensor(fs[i], device=device))
              for p, fs in zip(params_seq, fs_stacks)]
        cam_i = dataclasses.replace(camera, view_to_world=torch.as_tensor(
            np.asarray(vtw, np.float32), device=device))
        out = render_scene(ps, configs, cam_i, opaque, height, width, tex_data=tex_data,
                           pano_data=pano_data, pano_meta=pano_meta)
        color = out["color"]
        if taa is not None:
            color, history_depth, _ = taa_mod.resolve_plain(
                resolves[i], color, out["linear_depth"], history, history_depth)
            history = color
        colors.append(color)
        alphas.append(out["alpha"])
    return {"color": torch.stack(colors), "alpha": torch.stack(alphas)}
