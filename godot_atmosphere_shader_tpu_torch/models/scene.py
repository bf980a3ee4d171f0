"""Scene API: the ``PlanetAtmosphere`` node as a parameter manager.

Counterpart of ``godot_atmosphere_shader_tpu/models/scene.py``: the
reference node's properties and ``u_*`` uniform surface, the near/far mode
switch with its 1.1 hysteresis margin, the interior cloud-LOD policy, and
``Scene.render``, which sorts the layers far to near, plans the far-mode
row bands (``render/lod.py``) and sends CUDA tensors to the megakernel's
layer chain and CPU tensors to its plain version
(``ops/kernels/megakernel.py``), and ``Scene.render_flight``, which renders
K frames of a camera path and time sequence, every layer fullscreen, plain
or temporally accumulated (the TAA resolve, ``ops/kernels/taa.py``), on one
device or row-sharded over a mesh (``parallel/sharding.py``).
Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``).  A layer with a baked cloud field renders in the
megakernel's texture mode: each baked texture is packed into a mip pyramid
once per texture object (kept on the scene's device) and the config gains
its meta and its knot flag, as the JAX package's ``Scene._pallas_plan``
does; a procedural field beside it keeps its spec.  A panorama sky
(``OpaqueScene.panorama``) is packed the same way, into three channel
pyramids once per panorama object
(``Scene._pano_plan``), which the pass that runs the opaque scene samples.
``Scene.apply_environment`` runs the scene's output stage, the
environment's HDR glow (``render/glow.py``), on a rendered frame.

Not ported yet (they raise ``NotImplementedError``): ``od_mode="lut"`` and
large-world rebasing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..ops.kernels.megakernel import (render_flight_megakernel, render_flight_taa,
                                      render_scene_megakernel)
from ..ops.kernels.texsample import (build_equirect_pyramid, build_latlong_pyramid,
                                     build_tex3d_pyramid)
from ..parallel.sharding import render_flight_taa_sharded
from ..render.glow import GlowSettings, apply_glow
from ..render.lod import EMPTY, layer_band
from ..render.opaque import OpaqueScene
from ..render.renderer import shared_reverse_z
from ..utils.camera import Camera
from ..utils.color import linear_to_srgb, srgb_to_linear
from .params import DEFAULT_VARIANT, VARIANTS, AtmosphereParams, VariantConfig

MODE_NEAR = 0
MODE_FAR = 1
SWITCH_MARGIN_RATIO = 1.1  # planet_atmosphere.gd:11
#: beyond this distance from the world origin the JAX package rebases the
#: world around the camera (not ported yet: such scenes raise)
LARGE_WORLD_THRESHOLD = 32768.0

#: ``source_color`` uniforms: sRGB in, linear stored
_COLOR_PARAMS = frozenset({
    "u_atmosphere_modulate", "u_atmosphere_ambient_color",
    "u_day_color0", "u_day_color1", "u_night_color0", "u_night_color1",
})
#: baked cloud textures (stored as f32 tensors on the layer's device, or None)
_TEXTURE_PARAMS = frozenset({"u_cloud_shape_texture", "u_cloud_coverage_cubemap"})

#: uniform name → AtmosphereParams field
_UNIFORM_TO_FIELD = {
    "u_planet_radius": "planet_radius",
    "u_atmosphere_height": "atmosphere_height",
    "u_sun_position": "sun_position",
    "u_density": "density",
    "u_sphere_depth_factor": "sphere_depth_factor",
    "u_scattering_strength": "scattering_strength",
    "u_scattering_wavelengths": "scattering_wavelengths",
    "u_atmosphere_modulate": "atmosphere_modulate",
    "u_atmosphere_ambient_color": "atmosphere_ambient_color",
    "u_day_color0": "day_color0",
    "u_day_color1": "day_color1",
    "u_night_color0": "night_color0",
    "u_night_color1": "night_color1",
    "u_day_night_transition_scale": "day_night_transition_scale",
    "u_cloud_density_scale": "cloud_density_scale",
    "u_cloud_bottom": "cloud_bottom",
    "u_cloud_top": "cloud_top",
    "u_cloud_blend": "cloud_blend",
    "u_cloud_shape_invert": "cloud_shape_invert",
    "u_cloud_coverage_bias": "cloud_coverage_bias",
    "u_cloud_shape_factor": "cloud_shape_factor",
    "u_cloud_shape_scale": "cloud_shape_scale",
    "u_cloud_shape_texture": "cloud_shape_texture",
    "u_cloud_coverage_cubemap": "cloud_coverage_cubemap",
    "u_world_to_model_matrix": "world_to_model",
    "u_cloud_coverage_rotation": "cloud_coverage_rotation",
    "u_optical_depth_texture": "optical_depth_lut",
}


class Node3D:
    """Minimal scene-tree node: a global transform, host float64."""

    def __init__(self, position=(0.0, 0.0, 0.0), transform=None, name=""):
        if transform is None:
            transform = np.eye(4)
            transform[:3, 3] = position
        self.transform = np.asarray(transform, np.float64)
        self.name = name

    @property
    def position(self):
        return self.transform[:3, 3]


class PlanetAtmosphere(Node3D):
    """The reference node's API over an :class:`AtmosphereParams` on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, planet_radius: float = 1.0, atmosphere_height: float = 0.1,
                 sun: Optional[Node3D] = None, custom_shader=None,
                 clouds_rotation_speed: float = 1.0,
                 force_fullscreen: bool = False, position=(0.0, 0.0, 0.0),
                 transform=None, name="PlanetAtmosphere", *, device="cuda",
                 **shader_params):
        super().__init__(position=position, transform=transform, name=name)
        self.device = torch.device(device)
        # host copies of the two radii: the mode switch reads them per frame
        self._radius = max(float(planet_radius), 0.0)
        self._height = max(float(atmosphere_height), 0.0)
        self._params = AtmosphereParams.create(
            planet_radius=self._radius, atmosphere_height=self._height,
            device=self.device)
        self._sun_position_host = np.array([5000.0, 0.0, 0.0], np.float32)
        self._config = VARIANTS[DEFAULT_VARIANT]
        self.clouds_rotation_speed = clouds_rotation_speed
        self.force_fullscreen = force_fullscreen
        self.sun = sun
        self.mode = MODE_FAR
        self.atmo_clip_distance = 0.0
        # the far-mode cull sphere's radius (scene.py:132,163-164)
        self.extra_cull_margin = self._radius + self._height
        self._interior_lod_active = False
        if custom_shader is not None:
            self.set_custom_shader(custom_shader)
        for k, v in shader_params.items():
            self.set_shader_parameter(k if k.startswith("u_") else "u_" + k, v)

    # -- exported properties (planet_atmosphere.gd:20-54) --------------------

    @property
    def planet_radius(self) -> float:
        return self._radius

    @planet_radius.setter
    def planet_radius(self, value: float):
        self.set_shader_parameter("u_planet_radius", max(float(value), 0.0))
        self._update_cull_margin()

    @property
    def atmosphere_height(self) -> float:
        return self._height

    @atmosphere_height.setter
    def atmosphere_height(self, value: float):
        self.set_shader_parameter("u_atmosphere_height", max(float(value), 0.0))
        self._update_cull_margin()

    def _update_cull_margin(self):
        # the radii as the device holds them (f32), as the JAX node reads them
        self.extra_cull_margin = (float(np.float32(self._radius))
                                  + float(np.float32(self._height)))

    def set_custom_shader(self, shader):
        """Variant switch: a variant name or a :class:`VariantConfig`."""
        self._config = VARIANTS[shader] if isinstance(shader, str) else shader

    @property
    def config(self) -> VariantConfig:
        return self._config

    # -- shader parameter surface (planet_atmosphere.gd:175-218) -------------

    def set_shader_parameter(self, param_name: str, value):
        field = _UNIFORM_TO_FIELD.get(param_name)
        if field is None:
            raise KeyError(f"unknown shader parameter {param_name!r}")
        if param_name == "u_optical_depth_texture":
            raise NotImplementedError(f"{param_name}: the optical-depth LUT is "
                                      "not ported yet (od_mode='analytic' only)")
        if param_name in _TEXTURE_PARAMS:
            if value is not None:
                value = torch.as_tensor(value, dtype=torch.float32,
                                        device=self.device).contiguous()
            self._params = dataclasses.replace(self._params, **{field: value})
            return
        if param_name == "u_sun_position":
            self._sun_position_host = np.asarray(value, np.float32)
        if param_name == "u_planet_radius":
            self._radius = float(value)
        if param_name == "u_atmosphere_height":
            self._height = float(value)
        if param_name in _COLOR_PARAMS:
            value = srgb_to_linear(np.asarray(value, np.float32)[:3], device=self.device)
        else:
            value = torch.as_tensor(np.asarray(value, np.float32), device=self.device)
        self._params = dataclasses.replace(self._params, **{field: value})

    def get_shader_parameter(self, param_name: str):
        field = _UNIFORM_TO_FIELD.get(param_name)
        if field is None:
            raise KeyError(f"unknown shader parameter {param_name!r}")
        params = self._params.resolve_frame_state()
        value = getattr(params, field)
        if param_name in _COLOR_PARAMS and value is not None:
            return linear_to_srgb(value)
        return value

    # -- per-frame update (planet_atmosphere.gd:285-341) ----------------------

    def update(self, time_s: float, cam_pos, cam_near: float = 0.1):
        """Per-frame uniform refresh from the host camera position: near/far
        mode, the interior cloud-LOD hysteresis, and the packed frame state
        (uploaded to the device)."""
        self.set_frame_state(self.frame_state_row(time_s, cam_pos, cam_near))

    def set_frame_state(self, row: np.ndarray):
        """Upload one packed frame-state row (24 f32) to the device."""
        self._params = dataclasses.replace(
            self._params, frame_state=torch.as_tensor(row, device=self.device))

    def frame_state_row(self, time_s: float, cam_pos, cam_near: float = 0.1) -> np.ndarray:
        """:meth:`update`'s work without the upload: advance the near/far
        mode and the interior-LOD hysteresis to this camera position and
        return the frame's packed state as a host row (a flight packs every
        frame's row before its first launch)."""
        cam_pos = np.asarray(cam_pos, np.float64)

        # 1.75 ≈ sqrt(3): cube far-mesh corner distance (:300-303)
        self.atmo_clip_distance = (1.75 * (self._radius + self._height + cam_near)
                                   * SWITCH_MARGIN_RATIO)
        d = float(np.linalg.norm(self.position - cam_pos))
        is_near = d < self.atmo_clip_distance
        self.mode = MODE_NEAR if (is_near or self.force_fullscreen) else MODE_FAR

        # interior cloud LOD: engage inside the shell, release at 1.1·(R+H)
        shell = self._radius + self._height
        if self._interior_lod_active:
            self._interior_lod_active = d < shell * SWITCH_MARGIN_RATIO
        else:
            self._interior_lod_active = d < shell

        if self.sun is not None:
            sun_pos = np.asarray(self.sun.position)
            self._sun_position_host = sun_pos
        else:
            sun_pos = self._sun_position_host
        r = self.transform[:3, :3]
        t = self.transform[:3, 3]
        w2m = np.eye(4)
        w2m[:3, :3] = r.T
        w2m[:3, 3] = -(r[0] * t[0] + r[1] * t[1] + r[2] * t[2])  # -Rᵀt
        angle = time_s * math.radians(self.clouds_rotation_speed)
        c, s = math.cos(angle), math.sin(angle)
        # Transform2D().rotated(a) acts as [[c, -s], [s, c]] on xz (:338-341)
        rot = np.array([[c, -s], [s, c]], np.float32)
        return AtmosphereParams.pack_frame_state(sun_pos, w2m, rot, time_s)

    def build_params(self) -> AtmosphereParams:
        return self._params

    def effective_config(self) -> VariantConfig:
        """The user config with the camera-conditional interior cloud LOD
        applied (``cloud_lod_interior``)."""
        c = self._config
        if c.cloud_lod_interior and c.clouds_enabled and self._interior_lod_active:
            return dataclasses.replace(c, cloud_lod=c.cloud_lod_interior)
        return c


class Scene:
    """A renderable collection: atmospheres + opaque geometry, on one
    device (the card unless the caller asks for the CPU), and an optional
    environment (:class:`GlowSettings`, the Godot Environment's glow block)
    for :meth:`apply_environment`."""

    def __init__(self, atmospheres=(), opaque: Optional[OpaqueScene] = None,
                 environment: Optional[GlowSettings] = None, *, device="cuda"):
        self.device = torch.device(device)
        self.atmospheres = list(atmospheres)
        self.opaque = opaque
        self.environment = environment
        self._tex_pyr_cache = {}
        self._cam_cache = None

    def _cam_host(self, camera: Camera) -> tuple:
        """The camera's ``view_to_world`` (float64) and vertical fov on the
        host: one device→host copy per distinct camera (the JAX package's
        ``_cam_info`` cache; the tensors' versions see in-place edits)."""
        t, f = camera.view_to_world, camera.fov_y_rad
        key = (id(t), t._version, id(f), f._version)
        if self._cam_cache is None or self._cam_cache[0] != key:
            host = torch.cat([t.detach().reshape(-1), f.detach().reshape(-1)]).cpu().numpy()
            # the entry holds the tensors, so their ids are not reused meanwhile
            self._cam_cache = (key, (t, f), host[:16].reshape(4, 4).astype(np.float64),
                               float(host[16]))
        return self._cam_cache[2], self._cam_cache[3]

    def _cam_pos(self, camera: Camera) -> np.ndarray:
        return self._cam_host(camera)[0][:3, 3]

    def _check_world_scale(self, cam_pos):
        m = float(np.max(np.abs(cam_pos)))
        for a in self.atmospheres:
            m = max(m, float(np.max(np.abs(a.position))))
        if m > LARGE_WORLD_THRESHOLD:
            raise NotImplementedError(
                "large-world (camera-relative) rendering is not ported yet")

    def update(self, time_s: float, camera: Camera):
        cam_pos = self._cam_pos(camera)
        cam_near = float(camera.near)
        for atmo in self.atmospheres:
            atmo.update(time_s, cam_pos, cam_near=cam_near)

    def _sorted_layers(self, camera: Camera):
        """Atmospheres far → near (Godot's transparent-pass sorting)."""
        cam_pos = self._cam_pos(camera)
        order = sorted(self.atmospheres,
                       key=lambda a: -float(np.linalg.norm(a.position - cam_pos)))
        return (order, tuple(a.build_params() for a in order),
                tuple(a.effective_config() for a in order))

    def _tex_pyramid(self, t, kind: str):
        """``(table on the scene's device, TexMeta)`` for a baked texture,
        built once per texture object, or ``None`` for a texture the
        pyramid builders refuse (``scene.py:566-592``): its layer is then
        sampled exactly, which only the plain chain does."""
        key = (id(t), kind)
        hit = self._tex_pyr_cache.get(key)
        if hit is not None and hit[0] is t:
            return hit[1]
        host = t.detach().cpu().numpy()
        try:
            data, meta = (build_tex3d_pyramid(host) if kind == "tex3d"
                          else build_latlong_pyramid(host))
            built = (torch.as_tensor(data, device=self.device), meta)
        except ValueError:
            built = None
        self._tex_pyr_cache[key] = (t, built)
        return built

    def _pano_plan(self):
        """``((r, g, b) tables on the scene's device, TexMeta)`` of the
        panorama sky, built once per panorama object, or ``None`` without
        one (``scene.py:594-619``).  The pyramid's width is the power of two
        at or below the image's, within [64, 2048]; a panorama that cannot
        be packed raises ``ValueError``."""
        t = self.opaque.panorama if self.opaque is not None else None
        if t is None:
            return None
        key = (id(t), "equirect")
        hit = self._tex_pyr_cache.get(key)
        if hit is not None and hit[0] is t:
            return hit[1]
        host = t.detach().cpu().numpy()
        if host.ndim != 3:
            raise ValueError(f"panorama must be (H, W, 3), got {host.shape}")
        width = 1 << int(np.log2(min(2048, max(64, host.shape[1]))))
        datas, meta = build_equirect_pyramid(host, width=width)
        built = (tuple(torch.as_tensor(d, device=self.device) for d in datas), meta)
        self._tex_pyr_cache[key] = (t, built)
        return built

    def apply_environment(self, color: torch.Tensor) -> torch.Tensor:
        """A rendered linear frame (H, W, 3) through the scene's environment
        (the HDR glow; ``scene.py:457-465``); unchanged without one or when
        it is disabled."""
        if self.environment is None or not self.environment.enabled:
            return color
        return apply_glow(color, self.environment)

    def _texture_plan(self, params, config):
        """Texture mode for a layer with a baked cloud field (``scene.py:
        621-661``): each field without a procedural spec gets its pyramid,
        its meta and its knot flag; a procedural field beside it stays as
        the config has it (knots or per step).  Returns the config and the
        ``(shape, coverage)`` tables, ``None`` for a procedural field.  A
        texture that cannot be packed leaves the layer as it is, its
        textures sampled exactly: the plain chain renders it, the kernel
        refuses it (no pyramid metas)."""
        if not config.clouds_enabled or (config.cloud_shape_noise is not None
                                         and config.cloud_coverage_noise is not None):
            return config, None
        if params.cloud_shape_texture is None and config.cloud_shape_noise is None:
            raise ValueError("clouds need cloud_shape_texture or a procedural spec")
        if params.cloud_coverage_cubemap is None and config.cloud_coverage_noise is None:
            raise ValueError("clouds need cloud_coverage_cubemap or a procedural spec")
        change, tables = {}, [None, None]
        for i, (texture, spec, kind, name) in enumerate((
                (params.cloud_shape_texture, config.cloud_shape_noise, "tex3d", "shape"),
                (params.cloud_coverage_cubemap, config.cloud_coverage_noise, "latlong",
                 "coverage"))):
            if spec is not None:
                continue
            built = self._tex_pyramid(texture, kind)
            if built is None:
                return config, None
            tables[i] = built[0]
            change[f"cloud_{name}_tex_meta"] = built[1]
            change[f"cloud_{name}_interp"] = True
        return dataclasses.replace(config, **change), tuple(tables)

    @staticmethod
    def _check_layers(configs):
        """What the scene refuses for its layers: none, a layer mix that
        disagrees on ``reverse_z`` (``ValueError``, as the JAX
        ``shared_reverse_z``), and what is not ported: the optical-depth LUT."""
        if not configs:
            raise ValueError("the scene has no atmosphere layer")
        shared_reverse_z(configs)
        for config in configs:
            if config.od_mode != "analytic":
                raise NotImplementedError(f"od_mode={config.od_mode!r} is not ported yet")

    def _layer_bands(self, order, params, configs, tex_data, camera: Camera, height: int):
        """The far-LOD plan (``scene.py:497-546``): per layer, the screen-row
        band its shell can touch (``render/lod.py``).  Near-mode (or
        ``force_fullscreen``) layers stay fullscreen; layers whose shell
        no row can see are dropped; when every layer is dropped the nearest
        one stays, fullscreen (it shades nothing).  Returns ``(order,
        params, configs, tex_data, bands, band_rows)``, bands and rows
        ``None`` when no layer is banded."""
        v2w, fov = self._cam_host(camera)
        keep, bands, rows = [], [], []
        for i, atmo in enumerate(order):
            band = layer_band(atmo.mode, v2w, fov, height,
                              np.asarray(atmo.position, np.float64),
                              atmo.extra_cull_margin, 0.0, mode_far=MODE_FAR)
            if band == EMPTY:
                continue
            keep.append(i)
            bands.append(None if band is None else band[1])
            rows.append(0 if band is None else band[0])
        if not keep:
            keep, bands, rows = [len(order) - 1], [None], [0]
        sel = lambda seq: tuple(seq[i] for i in keep)  # noqa: E731
        if all(b is None for b in bands):
            return sel(order), sel(params), sel(configs), sel(tex_data), None, None
        return (sel(order), sel(params), sel(configs), sel(tex_data), tuple(bands),
                np.asarray(rows, np.int32))

    def render(self, camera: Camera, height: int, width: int) -> dict:
        """Render one frame: ``{"color": (H, W, 3), "alpha": (H, W)}``
        (alpha: the maximum over the layers).

        The layers render far to near, each far-mode layer on its row band;
        CUDA tensors go to the megakernel (one launch per layer, plus the
        opaque-only pass when the farthest layer is banded; the launch that
        runs the opaque pass draws the panorama sky), CPU tensors to its
        plain version; both return the same keys."""
        self._check_world_scale(self._cam_pos(camera))
        order, params, configs = self._sorted_layers(camera)
        self._check_layers(configs)
        plans = [self._texture_plan(p, c) for p, c in zip(params, configs)]
        configs = tuple(c for c, _ in plans)
        tex_data = tuple(t for _, t in plans)
        _, params, configs, tex_data, bands, band_rows = self._layer_bands(
            order, params, configs, tex_data, camera, height)
        pano_data, pano_meta = self._pano_plan() or (None, None)
        return render_scene_megakernel(params, configs, camera, self.opaque, height, width,
                                       tex_data=tex_data, bands=bands, band_rows=band_rows,
                                       pano_data=pano_data, pano_meta=pano_meta)

    def render_flight(self, camera: Camera, times, height: int, width: int,
                      cam_transforms=None, taa_blend=None, taa_depth_eps: float = 0.2,
                      taa_clamp: str = "minmax", taa_clamp_gamma: float = 1.25,
                      mesh=None, taa_halo="auto") -> dict:
        """Render K frames of a flight: ``{"color": (K, H, W, 3), "alpha":
        (K, H, W)}`` on the scene's device (``scene.py:663-789``).

        ``times``: (K,) scene times (cast to float32); ``cam_transforms``:
        optional (K, 4, 4) per-frame ``view_to_world`` transforms of
        ``camera`` (host arrays; default: ``camera``'s for every frame).
        Every frame's packed state is computed on the host first, per layer
        (the layers' order and configs are fixed once, from ``camera``,
        before the per-frame updates; the mode and interior-LOD state left
        behind are the last frame's).  Every layer renders fullscreen, far
        to near.  ``taa_blend``: resolve each frame against the previous
        one (``render_flight_taa``, with temporal jitter) with that blend,
        ``taa_depth_eps``, ``taa_clamp`` (``"minmax"`` or ``"variance"``)
        and ``taa_clamp_gamma``.  ``mesh`` (a ``parallel.sharding.RowMesh``,
        with ``taa_blend``): row-shard the TAA flight over the mesh, each
        shard exchanging ``taa_halo`` history rows with its neighbours per
        frame (``render_flight_taa_sharded``; ``"auto"`` sizes the halo from
        the camera motion, an int is checked against it)."""
        if mesh is not None and taa_blend is None:
            raise ValueError("mesh is only honored with taa_blend (the sharded TAA flight); "
                             "for a sharded non-TAA frame use "
                             "parallel.sharding.render_scene_megakernel_sharded per frame")
        times = np.asarray(times, np.float32)
        cam_pos = self._cam_pos(camera)
        self._check_world_scale(cam_pos)
        cam_near = float(camera.near)
        order, params, configs = self._sorted_layers(camera)
        self._check_layers(configs)
        if cam_transforms is not None:
            if isinstance(cam_transforms, torch.Tensor):
                cam_transforms = cam_transforms.detach().cpu().numpy()
            cam_transforms = np.asarray(cam_transforms, np.float32)
            if cam_transforms.shape != (len(times), 4, 4):
                raise ValueError(f"cam_transforms must be ({len(times)}, 4, 4), got "
                                 f"{cam_transforms.shape}")
        fs_stacks = []
        for atmo in order:
            rows = []
            for i, t in enumerate(times):
                cp = (cam_transforms[i, :3, 3].astype(np.float64) if cam_transforms is not None
                      else cam_pos)
                rows.append(atmo.frame_state_row(float(t), cp, cam_near))
            atmo.set_frame_state(rows[-1])
            fs_stacks.append(np.stack(rows))
        plans = [self._texture_plan(p, c) for p, c in zip(params, configs)]
        args = (params, fs_stacks, tuple(c for c, _ in plans), camera, self.opaque, height,
                width)
        pano_data, pano_meta = self._pano_plan() or (None, None)
        kw = dict(cam_stack=cam_transforms, tex_data=tuple(t for _, t in plans),
                  pano_data=pano_data, pano_meta=pano_meta)
        if taa_blend is None:
            return render_flight_megakernel(*args, **kw)
        taa_kw = dict(blend=float(taa_blend), depth_eps=float(taa_depth_eps),
                      clamp_mode=taa_clamp, clamp_gamma=float(taa_clamp_gamma), **kw)
        if mesh is not None:
            return render_flight_taa_sharded(*args, mesh, halo=taa_halo, **taa_kw)
        return render_flight_taa(*args, **taa_kw)
