"""The plain PyTorch frame: opaque pass, then one atmosphere layer (clouds
included) composited over it.

Counterpart of ``godot_atmosphere_shader_tpu/render/renderer.py::
render_frame_impl`` for a single layer.  This is the plain version the CUDA
megakernel (``ops/kernels/megakernel.py``) is held against, and the path
CPU tensors take.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.params import AtmosphereParams, VariantConfig
from ..utils.camera import Camera, rigid_inverse, world_ray_dirs
from ..utils.vecmath import Vec3
from .atmosphere_pass import composite_over, shade_atmosphere
from .jitter import jitter_plane
from .opaque import OpaqueScene, render_opaque


def planet_center(params: AtmosphereParams) -> Vec3:
    """World-space planet center: the translation of ``model → world``."""
    pc = rigid_inverse(params.world_to_model)[:3, 3]
    return Vec3(pc[0], pc[1], pc[2])


def render_frame(params: AtmosphereParams, config: VariantConfig,
                 camera: Camera, opaque: Optional[OpaqueScene],
                 height: int, width: int) -> dict:
    """Render one single-layer frame.  Returns ``color`` ``(H, W, 3)``,
    ``alpha`` ``(H, W)`` and, with an opaque scene, the nonlinear
    ``depth`` buffer — on the device of ``camera``."""
    device = camera.view_to_world.device
    params = params.resolve_frame_state()
    ray_dir = world_ray_dirs(camera, height, width)
    if opaque is not None:
        bg, depth, linear_depth = render_opaque(
            opaque, camera, height, width, reverse_z=config.reverse_z,
            ray_dir=ray_dir)
    else:
        bg = Vec3(*(torch.zeros((height, width), device=device)
                    for _ in range(3)))
        depth = None
        linear_depth = torch.full((height, width), 1e7, device=device)

    if config.temporal_jitter:
        raise NotImplementedError("temporal_jitter (flight/TAA) is not ported yet")
    jitter = jitter_plane(height, width, device=device)

    rgb, alpha, mask = shade_atmosphere(params, config, camera.position,
                                        ray_dir, linear_depth, jitter,
                                        planet_center(params))
    color = composite_over(bg, rgb, alpha, mask)
    out = {"color": torch.stack([color.x, color.y, color.z], dim=-1),
           "alpha": torch.clamp(torch.where(mask, alpha, 0.0), min=0.0)}
    if depth is not None:
        out["depth"] = depth
    return out
