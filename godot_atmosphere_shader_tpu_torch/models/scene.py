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

``Scene.render(renderer=)`` picks the route before any launch: ``"auto"``
takes the kernel on a CUDA device unless the scene's plan refuses it (the
optical-depth LUT, a baked texture or panorama the pyramid builders
refuse: the JAX package renders those by XLA), and then the plain version
samples them exactly; ``"kernel"`` raises ``ValueError`` for such a scene;
``"plain"`` renders the plain version on the scene's device.  Nothing
falls back from a failed build or launch.  A v2 layer with
``od_mode="lut"`` gets its optical-depth LUT baked on demand (once per
radius, height and density, on the layer's device).  Large worlds render
camera-relative: beyond ``LARGE_WORLD_THRESHOLD`` (or with
``Scene(large_world=True)``) every world position the device sees is
rebased around the camera in host float64 before the cast to float32 (the
reference's ``DOUBLE_PRECISION`` build); a flight takes one origin, its
first frame's camera.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import numpy as np
import torch

from ..ops.kernels import taa as taa_kernel
from ..ops.kernels.megakernel import (counters, render_flight_megakernel, render_flight_taa,
                                      render_scene_megakernel, render_scene_plain)
from ..ops.optical_depth import OpticalDepthCache
from ..ops.kernels.texsample import (build_equirect_pyramid, build_latlong_pyramid,
                                     build_tex3d_pyramid)
from ..parallel.sharding import render_flight_taa_sharded
from ..render.glow import GlowSettings, apply_glow
from ..render.lod import EMPTY, layer_band
from ..render.opaque import OpaqueScene
from ..render.renderer import render_flight_plain, shared_reverse_z
from ..utils import host_mirror
from ..utils.camera import Camera
from ..utils.color import linear_to_srgb, srgb_to_linear
from ..utils.profiling import span
from .params import DEFAULT_VARIANT, VARIANTS, AtmosphereParams, VariantConfig

MODE_NEAR = 0
MODE_FAR = 1
SWITCH_MARGIN_RATIO = 1.1  # planet_atmosphere.gd:11
#: beyond this distance from the world origin (of the camera or of any
#: atmosphere) the scene renders camera-relative: float32 spacing there is
#: 2^-9, and an Earth-scale scene (~6.4e6, spacing 0.5) marches visibly
#: quantized without the rebase
LARGE_WORLD_THRESHOLD = 32768.0
#: what ``Scene.render(renderer=)`` takes
RENDERERS = ("auto", "kernel", "plain")

#: set by the node itself; hidden from the user parameter surface
#: (planet_atmosphere.gd:68-77)
_API_SHADER_PARAMS = frozenset({
    "u_planet_radius", "u_atmosphere_height", "u_clip_mode", "u_sun_position",
    "u_world_to_model_matrix", "u_blue_noise_texture",
    "u_cloud_coverage_rotation", "u_optical_depth_texture",
})

#: ``source_color`` uniforms: sRGB in, linear stored
_COLOR_PARAMS = frozenset({
    "u_atmosphere_modulate", "u_atmosphere_ambient_color",
    "u_day_color0", "u_day_color1", "u_night_color0", "u_night_color1",
})
#: baked textures (stored as f32 tensors on the layer's device, or None)
_TEXTURE_PARAMS = frozenset({"u_cloud_shape_texture", "u_cloud_coverage_cubemap",
                             "u_optical_depth_texture"})

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
        self._uses_baked_optical_depth = False
        # the LUT's key, on the host
        self._density = float(host_mirror.host(self._params.density, "port.copy.density"))
        self._lut_cache = OpticalDepthCache(device=self.device)
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
        """Variant switch: a variant name or a :class:`VariantConfig`; a v2
        variant with ``od_mode="lut"`` samples the baked optical-depth LUT
        (``planet_atmosphere.gd:118-141``)."""
        self._config = VARIANTS[shader] if isinstance(shader, str) else shader
        self._uses_baked_optical_depth = (self._config.model == "v2"
                                          and self._config.od_mode == "lut")

    @property
    def custom_shader(self) -> VariantConfig:
        return self._config

    @property
    def config(self) -> VariantConfig:
        return self._config

    # -- shader parameter surface (planet_atmosphere.gd:175-218) -------------

    def set_shader_parameter(self, param_name: str, value):
        field = _UNIFORM_TO_FIELD.get(param_name)
        if field is None:
            raise KeyError(f"unknown shader parameter {param_name!r}")
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
        if param_name == "u_density":
            self._density = float(np.float32(value))
        if param_name in _COLOR_PARAMS:
            value = srgb_to_linear(np.asarray(value, np.float32)[:3], device=self.device)
        else:
            value = host_mirror.upload(np.asarray(value, np.float32), self.device,
                                       site="port.copy.shader_parameter")
        self._params = dataclasses.replace(self._params, **{field: value})

    def set_shader_param(self, param_name: str, value):
        """Deprecated alias of :meth:`set_shader_parameter`
        (``planet_atmosphere.gd:163-172``)."""
        warnings.warn("set_shader_param is deprecated, use set_shader_parameter",
                      DeprecationWarning, stacklevel=2)
        self.set_shader_parameter(param_name, value)

    def get_shader_parameter(self, param_name: str):
        field = _UNIFORM_TO_FIELD.get(param_name)
        if field is None:
            raise KeyError(f"unknown shader parameter {param_name!r}")
        params = self._params.resolve_frame_state()
        value = getattr(params, field)
        if param_name in _COLOR_PARAMS and value is not None:
            return linear_to_srgb(value)
        return value

    def get_shader_param(self, param_name: str):
        """Deprecated alias of :meth:`get_shader_parameter`."""
        warnings.warn("get_shader_param is deprecated, use get_shader_parameter",
                      DeprecationWarning, stacklevel=2)
        return self.get_shader_parameter(param_name)

    def get_property_list(self):
        """The user-facing ``shader_params/*`` names, as the inspector lists
        them (``planet_atmosphere.gd:185-197``)."""
        return [f"shader_params/{n}" for n in _UNIFORM_TO_FIELD
                if n not in _API_SHADER_PARAMS]

    def get_configuration_warnings(self):
        """(``planet_atmosphere.gd:221-227``)"""
        if self.sun is None:
            return ["The path to the sun is not assigned."]
        if not isinstance(self.sun, Node3D):
            return ["The assigned sun node is not a Node3D."]
        return []

    # -- per-frame update (planet_atmosphere.gd:285-341) ----------------------

    def update(self, time_s: float, camera: Optional[Camera] = None, cam_near: float = 0.1,
               cam_pos=None, origin=None):
        """Per-frame uniform refresh from the host camera position
        (``cam_pos``, else ``camera``'s, else a point 10 shell radii out
        along x): near/far mode, the interior cloud-LOD hysteresis, and the
        packed frame state (uploaded to the device).  ``origin`` (float64
        (3,)): the large-world rebase, sun and planet placed relative to
        it in float64 before the cast."""
        with span("port.scene.atmosphere_update"):
            if cam_pos is None and camera is not None:
                vtw, near = host_mirror.hosts((camera.view_to_world, camera.near),
                                              "port.copy.atmosphere_camera")
                cam_pos = vtw.numpy().astype(np.float64)[:3, 3]
                cam_near = float(near)
            elif cam_pos is None:
                cam_pos = self.position + np.array(
                    [10.0 * (self._radius + self._height + cam_near), 0.0, 0.0], np.float32)
            self.set_frame_state(self.frame_state_row(time_s, cam_pos, cam_near, origin=origin))

    def set_frame_state(self, row: np.ndarray):
        """Upload one packed frame-state row (24 f32) to the device, with
        its host mirror."""
        frame_state = host_mirror.upload(row, self.device, dtype=None,
                                         site="port.copy.frame_state")
        self._params = dataclasses.replace(self._params, frame_state=frame_state)

    def frame_state_row(self, time_s: float, cam_pos, cam_near: float = 0.1,
                        origin=None) -> np.ndarray:
        """:meth:`update`'s work without the upload: advance the near/far
        mode and the interior-LOD hysteresis to this camera position and
        return the frame's packed state as a host row (a flight packs every
        frame's row before its first launch), relative to ``origin`` where
        given."""
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
        if origin is not None:
            # model = w2m·(p_rel + origin): shift the translation, in float64
            o = np.asarray(origin, np.float64)
            sun_pos = np.asarray(sun_pos, np.float64) - o
            t = t - o
        w2m = np.eye(4)
        w2m[:3, :3] = r.T
        w2m[:3, 3] = -(r[0] * t[0] + r[1] * t[1] + r[2] * t[2])  # -Rᵀt
        angle = time_s * math.radians(self.clouds_rotation_speed)
        c, s = math.cos(angle), math.sin(angle)
        # Transform2D().rotated(a) acts as [[c, -s], [s, c]] on xz (:338-341)
        rot = np.array([[c, -s], [s, c]], np.float32)
        return AtmosphereParams.pack_frame_state(sun_pos, w2m, rot, time_s)

    def build_params(self) -> AtmosphereParams:
        """The layer's params, with the optical-depth LUT baked (once per
        radius, height and density) where the variant samples it."""
        params = self._params
        if self._uses_baked_optical_depth:
            lut = self._lut_cache.get(self._radius, self._height, self._density)
            params = dataclasses.replace(params, optical_depth_lut=lut)
        return params

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
    for :meth:`apply_environment`.  ``large_world``: render camera-relative
    (``None``: when the camera or an atmosphere lies beyond
    ``LARGE_WORLD_THRESHOLD`` of the world origin)."""

    def __init__(self, atmospheres=(), opaque: Optional[OpaqueScene] = None,
                 large_world: Optional[bool] = None,
                 environment: Optional[GlowSettings] = None, *, device="cuda"):
        self.device = torch.device(device)
        self.atmospheres = list(atmospheres)
        self.opaque = opaque
        self.environment = environment
        self.large_world = large_world
        self._rebase_origin = None
        self._last_update_time = 0.0
        self._opaque_host_cache = {}
        self._rebased = None
        self._tex_pyr_cache = {}

    @staticmethod
    def _cam_host(camera: Camera) -> tuple:
        """The camera's ``view_to_world`` (float64) and vertical fov on the
        host: their host mirrors (the JAX package's ``_cam_info`` cache),
        or one device→host copy of a camera the port did not upload or
        that was edited since.  A large-world camera's float64 transform
        keeps its full precision."""
        m, fov = host_mirror.hosts((camera.view_to_world, camera.fov_y_rad),
                                   "port.copy.cam_host")
        return m.numpy().astype(np.float64), float(fov)

    def _cam_pos(self, camera: Camera) -> np.ndarray:
        return self._cam_host(camera)[0][:3, 3]

    def _large_world_active(self, cam_pos) -> bool:
        if self.large_world is not None:
            return self.large_world
        # the camera counts even without atmospheres: an opaque-only scene
        # at Earth-scale coordinates marches quantized unless rebased
        m = float(np.max(np.abs(cam_pos)))
        for a in self.atmospheres:
            m = max(m, float(np.max(np.abs(a.position))))
        return m > LARGE_WORLD_THRESHOLD

    def update(self, time_s: float, camera: Camera):
        with span("port.scene.update"):
            cam_pos = self._cam_pos(camera)
            cam_near = float(host_mirror.host(camera.near, "port.copy.camera_near"))
            origin = (np.array(cam_pos, np.float64) if self._large_world_active(cam_pos)
                      else None)
            self._rebase_origin = origin
            self._last_update_time = time_s
            for atmo in self.atmospheres:
                atmo.update(time_s, cam_pos=cam_pos, cam_near=cam_near, origin=origin)

    def _sync_rebase(self, camera: Camera):
        """Make the packed frame states camera-relative where large-world
        mode is on and the rebase origin is stale (the camera moved since
        :meth:`update`, or it was never called)."""
        cam_pos = self._cam_pos(camera)
        if not self._large_world_active(cam_pos):
            self._rebase_origin = None
            return
        if self._rebase_origin is None or not np.array_equal(self._rebase_origin, cam_pos):
            self.update(self._last_update_time, camera)

    def _rebased_view(self, camera: Camera):
        """The ``(camera, opaque)`` pair the device sees: with a rebase
        origin, every world position camera-relative, subtracted on the
        host in float64 and cast to float32 (the rebased opaque scene is
        built once per origin); without one, the scene's own (a float64
        camera cast to float32)."""
        origin = self._rebase_origin
        vtw = camera.view_to_world
        if origin is None:
            if vtw.dtype != torch.float32:
                camera = dataclasses.replace(camera, view_to_world=vtw.to(torch.float32))
            return camera, self.opaque
        m = self._cam_host(camera)[0]
        m[:3, 3] -= origin
        cam_rel = dataclasses.replace(camera, view_to_world=host_mirror.upload(
            m.astype(np.float32), vtw.device, site="port.copy.rebased_camera"))
        key = tuple(float(v) for v in origin)
        if self.opaque is None:
            return cam_rel, None
        if self._rebased is None or self._rebased[0] != key or self._rebased[1] is not self.opaque:
            self._rebased = (key, self.opaque,
                             self.opaque.rebased(origin, self._opaque_host_cache))
        return cam_rel, self._rebased[2]

    def _sorted_layers(self, camera: Camera):
        """Atmospheres far → near (Godot's transparent-pass sorting)."""
        with span("port.scene.sorted_layers"):
            cam_pos = self._cam_pos(camera)
            order = sorted(self.atmospheres,
                           key=lambda a: -float(np.linalg.norm(a.position - cam_pos)))
            return (order, tuple(a.build_params() for a in order),
                    tuple(a.effective_config() for a in order))

    def _tex_pyramid(self, t, kind: str):
        """``(table on the scene's device, TexMeta)`` for a baked texture,
        built once per texture object, or ``None`` for a texture the
        pyramid builders refuse (``scene.py:566-592``): the kernel's plan
        then refuses its layer."""
        key = (id(t), kind)
        hit = self._tex_pyr_cache.get(key)
        if hit is not None and hit[0] is t:
            return hit[1]
        with span("port.copy.tex_pyramid", t.device):
            host = t.detach().cpu().numpy()
        try:
            data, meta = (build_tex3d_pyramid(host) if kind == "tex3d"
                          else build_latlong_pyramid(host))
            with span("port.copy.tex_pyramid", self.device):
                built = (torch.as_tensor(data, device=self.device), meta)
        except ValueError:
            built = None
        self._tex_pyr_cache[key] = (t, built)
        return built

    def _pano_plan(self):
        """``((r, g, b) tables on the scene's device, TexMeta)`` of the
        panorama sky, built once per panorama object; ``(None, None)``
        without one, and ``None`` for a panorama that cannot be packed (the
        kernel's plan then refuses the scene; ``scene.py:594-619``).  The
        pyramid's width is the power of two at or below the image's, within
        [64, 2048]; a panorama that is not (H, W, 3) raises ``ValueError``."""
        t = self.opaque.panorama if self.opaque is not None else None
        if t is None:
            return None, None
        key = (id(t), "equirect")
        hit = self._tex_pyr_cache.get(key)
        if hit is not None and hit[0] is t:
            return hit[1]
        with span("port.copy.panorama", t.device):
            host = t.detach().cpu().numpy()
        if host.ndim != 3 or host.shape[2] != 3:
            raise ValueError(f"panorama must be (H, W, 3), got {host.shape}")
        try:
            width = 1 << int(np.log2(min(2048, max(64, host.shape[1]))))
            datas, meta = build_equirect_pyramid(host, width=width)
            tables = []
            for d in datas:
                with span("port.copy.panorama", self.device):
                    tables.append(torch.as_tensor(d, device=self.device))
            built = (tuple(tables), meta)
        except ValueError:
            built = None
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
        textures sampled exactly (:meth:`_kernel_plan` refuses it)."""
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

    def _kernel_plan(self, params, configs):
        """What the kernel renders of these layers, decided before any
        launch (the JAX package's ``_pallas_plan``, ``scene.py:621-661``,
        without its TPU test): ``(configs, tex_data, pano_data,
        pano_meta)``, the configs in texture mode where a field is baked;
        or ``None`` where the kernel does not take the scene, which the
        JAX package renders by XLA: the optical-depth LUT, a baked texture
        or a panorama the pyramid builders refuse."""
        with span("port.scene.kernel_plan"):
            if any(c.od_mode != "analytic" for c in configs):
                return None
            plans = [self._texture_plan(p, c) for p, c in zip(params, configs)]
            for (config, tex), original in zip(plans, configs):
                if original.clouds_enabled and tex is None and (
                        original.cloud_shape_noise is None
                        or original.cloud_coverage_noise is None):
                    return None
            pano = self._pano_plan()
            if pano is None:
                return None
            return (tuple(c for c, _ in plans), tuple(t for _, t in plans)) + tuple(pano)

    @staticmethod
    def _check_layers(configs):
        """What the scene refuses for its layers: none, and a layer mix
        that disagrees on ``reverse_z`` (``ValueError``, as the JAX
        ``shared_reverse_z``)."""
        if not configs:
            raise ValueError("the scene has no atmosphere layer")
        shared_reverse_z(configs)

    def _layer_bands(self, order, params, configs, tex_data, camera: Camera, height: int):
        """The far-LOD plan (``scene.py:497-546``): per layer, the screen-row
        band its shell can touch (``render/lod.py``), from the camera the
        device sees and each layer's centre relative to the rebase origin.
        Near-mode (or ``force_fullscreen``) layers stay fullscreen; layers
        whose shell no row can see are dropped; when every layer is dropped
        the nearest one stays, fullscreen (it shades nothing).  Returns
        ``(order, params, configs, tex_data, bands, band_rows)``, bands and
        rows ``None`` when no layer is banded."""
        with span("port.scene.layer_bands"):
            v2w, fov = self._cam_host(camera)
            origin = self._rebase_origin
            keep, bands, rows = [], [], []
            for i, atmo in enumerate(order):
                center = np.asarray(atmo.position, np.float64)
                if origin is not None:
                    center = center - origin
                band = layer_band(atmo.mode, v2w, fov, height, center,
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

    def render(self, camera: Camera, height: int, width: int, renderer: str = "auto") -> dict:
        """Render one frame: ``{"color": (H, W, 3), "alpha": (H, W)}``
        (alpha: the maximum over the layers), on the scene's device.

        The layers render far to near, each far-mode layer on its row band.
        ``renderer``: ``"auto"`` launches the kernel for CUDA tensors (one
        launch per layer, plus the opaque-only pass when the farthest layer
        is banded; the launch that runs the opaque pass draws the panorama
        sky) where :meth:`_kernel_plan` takes the scene, else renders the
        plain version, which samples what the plan refuses exactly;
        ``"kernel"`` raises ``ValueError`` where the plan refuses the scene;
        ``"plain"`` renders the plain version of the kernel's plan (or, where
        refused, the exact one) on the scene's device."""
        with span("port.scene.render"):
            if renderer not in RENDERERS:
                raise ValueError(f"renderer must be one of {RENDERERS}, got {renderer!r}")
            self._sync_rebase(camera)
            order, params, configs = self._sorted_layers(camera)
            camera, opaque = self._rebased_view(camera)
            self._check_layers(configs)
            plan = self._kernel_plan(params, configs)
            if plan is None and renderer == "kernel":
                raise ValueError("the kernel renderer needs analytic optical depth and baked "
                                 "textures and panorama that pack into pyramids")
            tex_data = (None,) * len(configs)
            pano_data = pano_meta = None
            if plan is not None:
                configs, tex_data, pano_data, pano_meta = plan
            _, params, configs, tex_data, bands, band_rows = self._layer_bands(
                order, params, configs, tex_data, camera, height)
            if plan is not None and renderer != "plain":
                return render_scene_megakernel(params, configs, camera, opaque, height, width,
                                               tex_data=tex_data, bands=bands, band_rows=band_rows,
                                               pano_data=pano_data, pano_meta=pano_meta)
            out = render_scene_plain(params, configs, camera, opaque, height, width,
                                     tex_data=tex_data, bands=bands, band_rows=band_rows,
                                     pano_data=pano_data, pano_meta=pano_meta)
            return {"color": out["color"], "alpha": out["alpha"]}

    def render_flight(self, camera: Camera, times, height: int, width: int,
                      cam_transforms=None, taa_blend=None, taa_depth_eps: float = 0.2,
                      taa_clamp: str = "minmax", taa_clamp_gamma: float = 1.25,
                      mesh=None, taa_halo="auto") -> dict:
        """Render K frames of a flight: ``{"color": (K, H, W, 3), "alpha":
        (K, H, W)}`` on the scene's device (``scene.py:663-789``).

        ``times``: (K,) scene times (cast to float32); ``cam_transforms``:
        optional (K, 4, 4) per-frame ``view_to_world`` transforms of
        ``camera`` (host arrays, float64 kept for a large world; default:
        ``camera``'s for every frame).  A large-world flight rebases every
        frame by one origin, the first frame's camera: its opaque scene,
        frame states and transforms (the TAA reprojection reads the
        rebased ones).  Every frame's packed state is computed on the host
        first, per layer (the layers' order and configs are fixed once,
        from ``camera``, before the per-frame updates; the mode and
        interior-LOD state left behind are the last frame's).  Every layer
        renders fullscreen, far to near: through the kernel for CUDA
        tensors where :meth:`_kernel_plan` takes the scene, else (and for
        CPU tensors) the plain flight.  ``taa_blend``: resolve each frame
        against the previous one (``render_flight_taa``, with temporal
        jitter) with that blend, ``taa_depth_eps``, ``taa_clamp``
        (``"minmax"`` or ``"variance"``) and ``taa_clamp_gamma``.  ``mesh``
        (a ``parallel.sharding.RowMesh``, with ``taa_blend``): row-shard the
        TAA flight over the mesh, each shard exchanging ``taa_halo`` history
        rows with its neighbours per frame (``render_flight_taa_sharded``;
        ``"auto"`` sizes the halo from the camera motion, an int is checked
        against it)."""
        with span("port.scene.render_flight"):
            if mesh is not None and taa_blend is None:
                raise ValueError("mesh is only honored with taa_blend (the sharded TAA flight); "
                                 "for a sharded non-TAA frame use "
                                 "parallel.sharding.render_scene_megakernel_sharded per frame")
            times = np.asarray(times, np.float32)
            cam_pos = self._cam_pos(camera)
            cam_near = float(host_mirror.host(camera.near, "port.copy.camera_near"))
            order, params, configs = self._sorted_layers(camera)
            self._check_layers(configs)
            if cam_transforms is not None:
                if isinstance(cam_transforms, torch.Tensor):
                    with span("port.copy.flight_transforms", cam_transforms.device):
                        cam_transforms = cam_transforms.detach().cpu().numpy()
                cam_transforms = np.asarray(cam_transforms)
                if cam_transforms.dtype != np.float64:
                    cam_transforms = cam_transforms.astype(np.float32)
                if cam_transforms.shape != (len(times), 4, 4):
                    raise ValueError(f"cam_transforms must be ({len(times)}, 4, 4), got "
                                     f"{cam_transforms.shape}")
            origin = None
            if self._large_world_active(cam_pos):
                origin = np.array(cam_transforms[0, :3, 3] if cam_transforms is not None
                                  else cam_pos, np.float64)
            self._rebase_origin = origin
            fs_stacks = []
            with span("port.scene.frame_states"):
                for atmo in order:
                    rows = []
                    for i, t in enumerate(times):
                        cp = (cam_transforms[i, :3, 3].astype(np.float64)
                              if cam_transforms is not None else cam_pos)
                        rows.append(atmo.frame_state_row(float(t), cp, cam_near, origin=origin))
                    atmo.set_frame_state(rows[-1])
                    fs_stacks.append(np.stack(rows))
            camera, opaque = self._rebased_view(camera)
            if cam_transforms is not None:
                if origin is not None:
                    cam_transforms = np.asarray(cam_transforms, np.float64).copy()
                    cam_transforms[:, :3, 3] -= origin
                cam_transforms = cam_transforms.astype(np.float32)
            plan = self._kernel_plan(params, configs)
            kw = dict(cam_stack=cam_transforms)
            if plan is not None:
                configs, tex_data, pano_data, pano_meta = plan
                kw.update(tex_data=tex_data, pano_data=pano_data, pano_meta=pano_meta)
            args = (params, fs_stacks, configs, camera, opaque, height, width)
            taa_kw = dict(blend=float(taa_blend), depth_eps=float(taa_depth_eps),
                          clamp_mode=taa_clamp, clamp_gamma=float(taa_clamp_gamma), **kw) \
                if taa_blend is not None else None
            if plan is None:
                return self._plain_flight(args, cam_transforms, taa_kw, mesh)
            if taa_blend is None:
                return render_flight_megakernel(*args, **kw)
            if mesh is not None:
                return render_flight_taa_sharded(*args, mesh, halo=taa_halo, **taa_kw)
            return render_flight_taa(*args, **taa_kw)

    @staticmethod
    def _plain_flight(args, cam_transforms, taa_kw, mesh):
        """The exact plain flight of a scene the kernel's plan refuses."""
        if mesh is not None:
            raise ValueError("the sharded TAA flight needs a scene the kernel takes "
                             "(analytic optical depth, packable textures and panorama)")
        settings = None
        if taa_kw is not None:
            settings = taa_kernel.TaaSettings(taa_kw["blend"], taa_kw["depth_eps"],
                                              taa_kw["clamp_mode"], taa_kw["clamp_gamma"])
            taa_kernel.check_shapes(args[5], args[5], args[6], settings.clamp_mode)
            args = (args[0], args[1], tuple(dataclasses.replace(c, temporal_jitter=True)
                                            for c in args[2])) + args[3:]
            taa_kernel.counters.plain_calls += len(args[1][0])
        counters.plain_calls += len(args[1][0])
        return render_flight_plain(*args, cam_stack=cam_transforms, taa=settings)
