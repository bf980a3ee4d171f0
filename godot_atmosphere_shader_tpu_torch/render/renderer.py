"""The plain PyTorch frame: opaque pass, then one atmosphere layer (clouds
included) composited over it.

Counterpart of ``godot_atmosphere_shader_tpu/render/renderer.py::
render_frame_impl`` for a single layer.  This is the plain version the CUDA
megakernel (``ops/kernels/megakernel.py``) is held against, and the path
CPU tensors take.  Baked cloud textures come in two forms:

* exact sampling (no ``tex_data``): the textures of ``params`` are sampled
  per knot with the exact samplers, the twin of the JAX ``renderer="xla"``;
* pyramid sampling (a config carrying ``TexMeta``s and ``tex_data``): the
  megakernel's texture mode, whose samplers choose a mip level per batch —
  per 32×128 tile of the megakernel's grid and knot group.  The frame is
  then rendered on that grid padded to whole tiles (the last tile's extra
  rows and columns are real rays past the frame edge, part of its
  batches) and cropped.

:func:`render_flight_plain` is the counterpart of ``render_flight_xla``: K
frames of a flight by a host loop over :func:`render_frame`, optionally
each resolved against the previous one by the plain TAA resolve.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models.params import AtmosphereParams, VariantConfig
from ..ops.kernels import taa as taa_mod
from ..ops.kernels.texsample import pyramid_samplers
from ..utils.camera import Camera, rigid_inverse, world_ray_dirs
from ..utils.vecmath import Vec3
from .atmosphere_pass import composite_over, shade_atmosphere
from .jitter import apply_temporal_offset, jitter_plane, temporal_offset
from .opaque import OpaqueScene, render_opaque


def planet_center(params: AtmosphereParams) -> Vec3:
    """World-space planet center: the translation of ``model → world``."""
    pc = rigid_inverse(params.world_to_model)[:3, 3]
    return Vec3(pc[0], pc[1], pc[2])


#: the megakernel's tile: one batch of the pyramid samplers per knot group
TILE_ROWS, TILE_COLS = 32, 128


def render_frame(params: AtmosphereParams, config: VariantConfig,
                 camera: Camera, opaque: Optional[OpaqueScene],
                 height: int, width: int, tex_data=None) -> dict:
    """Render one single-layer frame.  Returns ``color`` ``(H, W, 3)``,
    ``alpha`` ``(H, W)``, ``linear_depth`` ``(H, W)`` (the opaque pass's,
    before the sphere-depth blend; 1e7 for sky) and, with an opaque scene,
    the nonlinear ``depth`` buffer — on the device of ``camera``.
    ``tex_data`` is the ``(shape, coverage)`` pyramid tables of a config
    with ``TexMeta``s."""
    device = camera.view_to_world.device
    params = params.resolve_frame_state()
    shape_fn = coverage_fn = None
    rows, cols = height, width
    metas = (config.cloud_shape_tex_meta, config.cloud_coverage_tex_meta)
    if any(m is not None for m in metas):
        if tex_data is None or None in metas:
            raise ValueError("pyramid sampling needs both TexMetas and their "
                             "(shape, coverage) tables")
        group = config.cloud_lod * max(config.cloud_coverage_lod, 1)
        if TILE_ROWS % group:
            raise ValueError(f"cloud_lod·cloud_coverage_lod = {group} must "
                             f"divide the tile height {TILE_ROWS}")
        rows = -(-height // TILE_ROWS) * TILE_ROWS
        cols = -(-width // TILE_COLS) * TILE_COLS
        shape_fn, coverage_fn = pyramid_samplers(config, *tex_data, TILE_ROWS // group)
    ray_dir = world_ray_dirs(camera, height, width, rows=rows, cols=cols)
    if opaque is not None:
        bg, depth, linear_depth = render_opaque(
            opaque, camera, rows, cols, reverse_z=config.reverse_z,
            ray_dir=ray_dir)
    else:
        bg = Vec3(*(torch.zeros((rows, cols), device=device)
                    for _ in range(3)))
        depth = None
        linear_depth = torch.full((rows, cols), 1e7, device=device)

    jitter = jitter_plane(rows, cols, device=device)
    if config.temporal_jitter:
        # golden-ratio offset keyed on scene time: successive frames of a
        # flight get decorrelated jitter (megakernel.py:385-390)
        jitter = apply_temporal_offset(jitter, temporal_offset(float(params.time)))

    rgb, alpha, mask = shade_atmosphere(params, config, camera.position,
                                        ray_dir, linear_depth, jitter,
                                        planet_center(params), shape_fn=shape_fn,
                                        coverage_fn=coverage_fn)
    color = composite_over(bg, rgb, alpha, mask)
    out = {"color": torch.stack([color.x, color.y, color.z], dim=-1),
           "alpha": torch.clamp(torch.where(mask, alpha, 0.0), min=0.0),
           "linear_depth": linear_depth}
    if depth is not None:
        out["depth"] = depth
    return {k: v[:height, :width] for k, v in out.items()}


def render_flight_plain(params: AtmosphereParams, frame_states, config: VariantConfig,
                        camera: Camera, opaque: Optional[OpaqueScene], height: int,
                        width: int, cam_stack=None, tex_data=None,
                        taa: Optional[taa_mod.TaaSettings] = None) -> dict:
    """K frames of a flight on the device of ``camera``: ``{"color":
    (K, H, W, 3), "alpha": (K, H, W)}``.  ``frame_states``: (K, 24) host
    rows of packed frame state; ``cam_stack``: optional (K, 4, 4) host
    ``view_to_world`` transforms (default: ``camera``'s).  With ``taa``,
    each frame (rendered with the config as given: the TAA flight forces
    ``temporal_jitter``) is resolved against the previous resolved frame;
    frame 0 against zero history at depth 1e7 with blend 1.0."""
    device = camera.view_to_world.device
    frame_states = np.asarray(frame_states, np.float32)
    if cam_stack is None:
        vtw = camera.view_to_world.detach().cpu().numpy()
        cam_stack = np.broadcast_to(vtw, (len(frame_states), 4, 4))
    f32 = dict(dtype=torch.float32, device=device)
    if taa is not None:
        resolves = taa_mod.flight_constants(camera, cam_stack, taa, height, width)
        history = torch.zeros((height, width, 3), **f32)
        history_depth = torch.full((height, width), taa_mod.DEPTH_CLAMP, **f32)
    colors, alphas = [], []
    for i, (fs, vtw) in enumerate(zip(frame_states, cam_stack)):
        p_i = dataclasses.replace(params, frame_state=torch.as_tensor(fs, device=device))
        cam_i = dataclasses.replace(camera, view_to_world=torch.as_tensor(
            np.asarray(vtw, np.float32), device=device))
        out = render_frame(p_i, config, cam_i, opaque, height, width, tex_data=tex_data)
        color = out["color"]
        if taa is not None:
            color, history_depth, _ = taa_mod.resolve_plain(
                resolves[i], color, out["linear_depth"], history, history_depth)
            history = color
        colors.append(color)
        alphas.append(out["alpha"])
    return {"color": torch.stack(colors), "alpha": torch.stack(alphas)}
