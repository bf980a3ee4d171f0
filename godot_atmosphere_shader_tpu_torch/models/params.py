"""Runtime parameters and compile-time variant configs.

Counterpart of ``godot_atmosphere_shader_tpu/models/params.py``:

1. :class:`VariantConfig` — the reference's shader ``#define`` matrix, a
   frozen dataclass with every field, name and default of the JAX package's
   config (fields the port does not use yet are kept, so configs compare one
   to one);
2. :class:`AtmosphereParams` — the shader uniforms as tensors (names without
   the ``u_`` prefix, the shader-declaration defaults), on an explicit
   device.

Color uniforms are declared sRGB in the shaders; ``create`` converts them to
linear, as Godot does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.noise import NoiseSpec
from ..utils import host_mirror
from ..utils.color import srgb_to_linear


@dataclasses.dataclass
class AtmosphereParams:
    """The uniform surface of one atmosphere, as tensors on one device."""

    planet_radius: torch.Tensor
    atmosphere_height: torch.Tensor
    sun_position: torch.Tensor  # (3,) world space
    density: torch.Tensor
    sphere_depth_factor: torch.Tensor
    scattering_strength: torch.Tensor
    scattering_wavelengths: torch.Tensor  # (3,)
    atmosphere_modulate: torch.Tensor  # (3,) linear
    atmosphere_ambient_color: torch.Tensor  # (3,) linear
    day_color0: torch.Tensor  # (3,) linear (v1 model)
    day_color1: torch.Tensor
    night_color0: torch.Tensor
    night_color1: torch.Tensor
    day_night_transition_scale: torch.Tensor
    cloud_density_scale: torch.Tensor
    cloud_bottom: torch.Tensor
    cloud_top: torch.Tensor
    cloud_blend: torch.Tensor
    cloud_shape_invert: torch.Tensor
    cloud_coverage_bias: torch.Tensor
    cloud_shape_factor: torch.Tensor
    cloud_shape_scale: torch.Tensor
    cloud_coverage_rotation: torch.Tensor  # (2, 2)
    world_to_model: torch.Tensor  # (4, 4)
    time: torch.Tensor
    # baked media (None ⇒ procedural per config): the optical-depth LUT
    # (od_mode="lut"), the shape texture and the coverage cubemap
    optical_depth_lut: Optional[torch.Tensor] = None  # (256, 256)
    cloud_shape_texture: Optional[torch.Tensor] = None  # (S, S, S)
    cloud_coverage_cubemap: Optional[torch.Tensor] = None  # (6, R, R)
    # packed per-frame dynamics: (24,) = sun_position(3) ‖ world_to_model(16)
    # ‖ coverage_rotation(4) ‖ time(1); overrides those four fields
    frame_state: Optional[torch.Tensor] = None

    def resolve_frame_state(self) -> "AtmosphereParams":
        """Unpack ``frame_state`` into the individual fields."""
        if self.frame_state is None:
            return self
        fs = self.frame_state
        return dataclasses.replace(
            self,
            sun_position=fs[0:3],
            world_to_model=fs[3:19].reshape(4, 4),
            cloud_coverage_rotation=fs[19:23].reshape(2, 2),
            time=fs[23],
            frame_state=None,
        )

    @staticmethod
    def pack_frame_state(sun_position, world_to_model, coverage_rotation,
                         time_s) -> np.ndarray:
        out = np.empty(24, np.float32)
        out[0:3] = np.asarray(sun_position, np.float32)
        out[3:19] = np.asarray(world_to_model, np.float32).reshape(-1)
        out[19:23] = np.asarray(coverage_rotation, np.float32).reshape(-1)
        out[23] = time_s
        return out

    @staticmethod
    def create(planet_radius=1.0, atmosphere_height=0.1,
               sun_position=(5000.0, 0.0, 0.0), density=0.2,
               sphere_depth_factor=0.0, scattering_strength=20.0,
               scattering_wavelengths=(700.0, 530.0, 440.0),
               atmosphere_modulate=(1.0, 1.0, 1.0),
               atmosphere_ambient_color=(0.0, 0.0, 0.002),
               day_color0=(0.5, 0.8, 1.0), day_color1=(0.5, 0.8, 1.0),
               night_color0=(0.2, 0.4, 0.8), night_color1=(0.2, 0.4, 0.8),
               day_night_transition_scale=2.0,
               cloud_density_scale=50.0, cloud_bottom=0.2, cloud_top=0.5,
               cloud_blend=0.5, cloud_shape_invert=0.0,
               cloud_coverage_bias=0.0, cloud_shape_factor=0.8,
               cloud_shape_scale=1.0, cloud_coverage_rotation=None,
               world_to_model=None, time=0.0,
               colors_are_srgb: bool = True, *, device) -> "AtmosphereParams":
        """Params with the shader-declaration defaults on ``device``, each
        uploaded with its host mirror (``utils/host_mirror.py``) but the
        sRGB colors, which are converted on ``device``."""

        def f32(v):
            return host_mirror.upload(np.asarray(v, np.float32), device,
                                      site="port.copy.params_create")

        def color(v):
            return srgb_to_linear(v, device=device) if colors_are_srgb else f32(v)

        if cloud_coverage_rotation is None:
            cloud_coverage_rotation = np.eye(2, dtype=np.float32)
        if world_to_model is None:
            world_to_model = np.eye(4, dtype=np.float32)
        return AtmosphereParams(
            planet_radius=f32(planet_radius),
            atmosphere_height=f32(atmosphere_height),
            sun_position=f32(sun_position),
            density=f32(density),
            sphere_depth_factor=f32(sphere_depth_factor),
            scattering_strength=f32(scattering_strength),
            scattering_wavelengths=f32(scattering_wavelengths),
            atmosphere_modulate=color(atmosphere_modulate),
            atmosphere_ambient_color=color(atmosphere_ambient_color),
            day_color0=color(day_color0), day_color1=color(day_color1),
            night_color0=color(night_color0), night_color1=color(night_color1),
            day_night_transition_scale=f32(day_night_transition_scale),
            cloud_density_scale=f32(cloud_density_scale),
            cloud_bottom=f32(cloud_bottom),
            cloud_top=f32(cloud_top),
            cloud_blend=f32(cloud_blend),
            cloud_shape_invert=f32(cloud_shape_invert),
            cloud_coverage_bias=f32(cloud_coverage_bias),
            cloud_shape_factor=f32(cloud_shape_factor),
            cloud_shape_scale=f32(cloud_shape_scale),
            cloud_coverage_rotation=f32(cloud_coverage_rotation),
            world_to_model=f32(world_to_model),
            time=f32(time),
        )


@dataclasses.dataclass(frozen=True)
class ProceduralField:
    """A procedural stand-in for a baked texture: noise spec + domain scale
    (texture-period analog for the shape field, ``NoiseCubemap.scale`` for
    the coverage field)."""

    noise: NoiseSpec
    scale: Tuple[float, float, float] = (64.0, 64.0, 64.0)


@dataclasses.dataclass(frozen=True)
class VariantConfig:
    """Compile-time variant switches — the reference's ``#define`` matrix.

    Field for field the JAX package's ``VariantConfig`` (its docstrings
    explain each one).  The port's render paths honour every field but
    ``march_unroll`` (a TPU compile setting, ignored); ``od_mode="lut"``
    renders by the plain route (the kernel samples no LUT, as the JAX
    megakernel does not).
    """

    model: str = "v2"
    atmosphere_steps: int = 8
    clouds_enabled: bool = False
    cloud_steps: int = 32
    raymarched_lighting: bool = False
    clouds_always_low_quality: bool = True
    reverse_z: bool = True
    od_mode: str = "analytic"
    cloud_shape_noise: Optional[ProceduralField] = None
    cloud_coverage_noise: Optional[ProceduralField] = None
    cloud_coverage_interp: bool = False
    cloud_coverage_knots: int = 8
    cloud_coverage_lod: int = 1
    tile_cull: bool = True
    cloud_lod: int = 1
    cloud_lod_interior: int = 0
    cloud_shape_interp: bool = False
    cloud_shape_knots: int = 16
    knot_dynamic: bool = False
    cloud_shape_tex_meta: object = None
    cloud_coverage_tex_meta: object = None
    texture_window_rows: int = 16
    texture_band_rows: int = 16
    texture_band_max_slices: int = 32
    temporal_jitter: bool = False
    texture_knot_group: int = 8
    cubemap_seamless: bool = True
    march_unroll: bool = False


#: The reference's shader variant files, name → config.
VARIANTS = {
    "no_clouds": VariantConfig(model="v2", atmosphere_steps=8),
    "clouds": VariantConfig(model="v2", atmosphere_steps=8,
                            clouds_enabled=True, cloud_steps=32),
    "clouds_high": VariantConfig(model="v2", atmosphere_steps=8,
                                 clouds_enabled=True, cloud_steps=64),
    "clouds_high_rm": VariantConfig(model="v2", atmosphere_steps=8,
                                    clouds_enabled=True, cloud_steps=64,
                                    raymarched_lighting=True),
    "v1_no_clouds": VariantConfig(model="v1", atmosphere_steps=16),
    "v1_clouds": VariantConfig(model="v1", atmosphere_steps=16,
                               clouds_enabled=True, cloud_steps=32),
    "v1_clouds_high": VariantConfig(model="v1", atmosphere_steps=16,
                                    clouds_enabled=True, cloud_steps=64),
}

DEFAULT_VARIANT = "no_clouds"

#: Named step-count profiles beyond the reference's shader files.
PROFILES = {
    "gas_giant": VariantConfig(model="v2", atmosphere_steps=64),
}
