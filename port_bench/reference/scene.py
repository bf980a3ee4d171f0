"""The reference's own scene: a configuration file's numbers made into the
frozen plain path's inputs, and the frames and flights the benchmark
compares the program's with.

Nothing here reads the program: the parameters, the frame state, the
opaque scene and the cameras are built from the configuration file and the
traffic's poses and times, as the port's ``models/scene.py`` builds them
(the node's frame state, ``planet_atmosphere.gd``: the sun's position, the
world→model transform and the clouds' rotation of ``clouds_rotation_speed``
degrees per second).  One layer, drawn fullscreen: the reference refuses a
camera far enough out for the far-mode band plan.

A configuration whose fields are baked textures carries a ``"textures"``
block: per baked field its noise, size and (coverage) scale.  The reference
bakes them itself on the run's device, packs their pyramids and puts the
layer in texture mode, as the port's ``Scene._texture_plan`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .camera import Camera
from .color import srgb_to_linear
from .noise import NoiseSpec
from .opaque import OpaqueScene
from .params import AtmosphereParams, ProceduralField, VariantConfig
from .renderer import render_flight_plain, render_scene
from .sampling import bake_noise_cubemap, bake_noise_texture3d
from .taa import TaaSettings
from .texsample import build_latlong_pyramid, build_tex3d_pyramid

#: the node's near/far switch margin (planet_atmosphere.gd:11)
SWITCH_MARGIN_RATIO = 1.1
#: shader uniform → AtmosphereParams field, for the uniforms a configuration sets
_UNIFORMS = {
    "u_density": "density", "u_scattering_strength": "scattering_strength",
    "u_atmosphere_modulate": "atmosphere_modulate",
    "u_atmosphere_ambient_color": "atmosphere_ambient_color",
    "u_cloud_density_scale": "cloud_density_scale", "u_cloud_bottom": "cloud_bottom",
    "u_cloud_top": "cloud_top", "u_cloud_blend": "cloud_blend",
    "u_cloud_shape_invert": "cloud_shape_invert",
    "u_cloud_coverage_bias": "cloud_coverage_bias",
    "u_cloud_shape_factor": "cloud_shape_factor", "u_cloud_shape_scale": "cloud_shape_scale",
}


def _field(d):
    return None if d is None else ProceduralField(noise=NoiseSpec(**d["noise"]),
                                                  scale=tuple(d["scale"]))


def variant(config: dict) -> VariantConfig:
    """The configuration's shader variant with its ``overrides``."""
    v = dict(config["variant"])
    v["cloud_shape_noise"] = _field(v["cloud_shape_noise"])
    v["cloud_coverage_noise"] = _field(v["cloud_coverage_noise"])
    v.update(config["overrides"])
    return VariantConfig(**v)


def texture_plan(config: VariantConfig, textures: dict, device) -> tuple:
    """Texture mode for a layer with a baked cloud field (a copy of the
    port's ``Scene._texture_plan``): each field without a procedural spec is
    baked from its entry of ``textures`` on ``device``, its pyramid packed on
    the host and its table put on ``device``, and gets its meta and its knot
    flag.  Returns the config and the ``(shape, coverage)`` tables, ``None``
    for a procedural field (both ``None`` where no field is baked)."""
    if not config.clouds_enabled or (config.cloud_shape_noise is not None
                                     and config.cloud_coverage_noise is not None):
        return config, None
    change, tables = {}, [None, None]
    for i, name in enumerate(("shape", "coverage")):
        if getattr(config, f"cloud_{name}_noise") is not None:
            continue
        if name not in textures:
            raise ValueError(f"clouds need a procedural {name} field or its texture")
        t = textures[name]
        spec = NoiseSpec(**t["noise"])
        if name == "shape":
            tex = bake_noise_texture3d(spec, int(t["size"]), device=device)
            data, meta = build_tex3d_pyramid(tex.cpu().numpy())
        else:
            tex = bake_noise_cubemap(spec, tuple(t["scale"]), int(t["size"]), device=device)
            data, meta = build_latlong_pyramid(tex.cpu().numpy())
        tables[i] = torch.as_tensor(data, device=device)
        change[f"cloud_{name}_tex_meta"] = meta
        change[f"cloud_{name}_interp"] = True
    return dataclasses.replace(config, **change), tuple(tables)


@dataclasses.dataclass
class RefScene:
    params: AtmosphereParams
    config: VariantConfig
    opaque: OpaqueScene
    camera: dict
    planet: dict
    sun_position: np.ndarray
    device: torch.device
    #: the layer's ``(shape, coverage)`` pyramid tables in texture mode, else None
    tex_data: Optional[tuple] = None

    def frame_state(self, time_s: float, cam_pos) -> np.ndarray:
        """The packed 24-float frame state of one frame, as the node packs it."""
        planet = self.planet
        shell = planet["planet_radius"] + planet["atmosphere_height"]
        clip = 1.75 * (shell + self.camera["near"]) * SWITCH_MARGIN_RATIO
        d = float(np.linalg.norm(np.asarray(planet["position"], np.float64)
                                 - np.asarray(cam_pos, np.float64)))
        if d >= clip:
            raise ValueError(f"the camera is {d} from the planet, beyond the fullscreen "
                             f"distance {clip}: the reference draws no far-mode band")
        if d < shell and self.config.cloud_lod_interior:
            raise ValueError("the reference draws no interior cloud LOD")
        t = np.asarray(planet["position"], np.float64)
        w2m = np.eye(4)
        w2m[:3, 3] = -t
        angle = time_s * math.radians(planet["clouds_rotation_speed"])
        c, s = math.cos(angle), math.sin(angle)
        rot = np.array([[c, -s], [s, c]], np.float32)
        return AtmosphereParams.pack_frame_state(self.sun_position, w2m, rot, time_s)

    def cam(self, view_to_world) -> Camera:
        c = self.camera
        return Camera.create(np.asarray(view_to_world, np.float32), fov_y_deg=c["fov_y_deg"],
                             near=c["near"], far=c["far"], device=self.device)


def build(config: dict, *, device) -> RefScene:
    """The reference scene of a configuration file (parsed JSON)."""
    sc = config["scene"]
    planet = sc["planet"]
    params = AtmosphereParams.create(planet_radius=planet["planet_radius"],
                                     atmosphere_height=planet["atmosphere_height"],
                                     device=device)
    for name, value in sc["shader_params"].items():
        if name in sc["srgb_colors"]:
            value = srgb_to_linear(np.asarray(value, np.float32)[:3], device=device)
        else:
            value = torch.as_tensor(np.asarray(value, np.float32), device=device)
        params = dataclasses.replace(params, **{_UNIFORMS[name]: value})
    op = sc["opaque"]
    spheres = []
    for s in op["spheres"]:
        albedo = (tuple(srgb_to_linear(np.asarray(s["albedo_srgb"], np.float32),
                                       device="cpu").tolist())
                  if "albedo_srgb" in s else tuple(s["albedo"]))
        spheres.append((tuple(s["center"]), s["radius"], albedo, s["unshaded"]))
    boxes = []
    for b in op["boxes"]:
        m = np.asarray(b["transform"], np.float32)
        r, t = m[:3, :3], m[:3, 3]
        w2b = np.eye(4, dtype=np.float32)
        w2b[:3, :3] = r.T
        w2b[:3, 3] = -(r[0] * t[0] + r[1] * t[1] + r[2] * t[2])
        boxes.append((w2b, tuple(b["half_size"]), tuple(b["albedo"])))
    opaque = OpaqueScene.create(spheres=spheres, boxes=boxes, light_dir=tuple(op["light_dir"]),
                                ambient=op["ambient"], sky_color=tuple(op["sky_color"]),
                                star_intensity=op["star_intensity"], device=device)
    layer, tex_data = texture_plan(variant(config), config.get("textures", {}), device)
    return RefScene(params=params, config=layer, opaque=opaque, camera=sc["camera"],
                    planet=planet, sun_position=np.asarray(sc["sun_position"], np.float32),
                    device=torch.device(device), tex_data=tex_data)


def render_frame(scene: RefScene, view_to_world, time_s: float, height: int,
                 width: int) -> dict:
    """One frame, as ``Scene.update`` then ``Scene.render`` draw it:
    ``{"color": (H, W, 3), "alpha": (H, W)}``."""
    fs = scene.frame_state(time_s, np.asarray(view_to_world, np.float64)[:3, 3])
    params = dataclasses.replace(scene.params,
                                 frame_state=torch.as_tensor(fs, device=scene.device))
    out = render_scene((params,), (scene.config,), scene.cam(view_to_world), scene.opaque,
                       height, width, tex_data=(scene.tex_data,))
    return {"color": out["color"], "alpha": out["alpha"]}


def render_flight(scene: RefScene, poses, times, height: int, width: int, taa: dict) -> dict:
    """One flight call, as ``Scene.render_flight(..., taa_blend=...)`` draws
    it: ``{"color": (K, H, W, 3), "alpha": (K, H, W)}``."""
    times = np.asarray(times, np.float32)
    fs = np.stack([scene.frame_state(float(t), np.asarray(m, np.float64)[:3, 3])
                   for t, m in zip(times, poses)])
    config = dataclasses.replace(scene.config, temporal_jitter=True)
    settings = TaaSettings(float(taa["blend"]), float(taa["depth_eps"]), taa["clamp"],
                           float(taa["clamp_gamma"]))
    return render_flight_plain((scene.params,), (fs,), (config,), scene.cam(poses[0]),
                               scene.opaque, height, width,
                               cam_stack=np.asarray(poses, np.float32),
                               tex_data=(scene.tex_data,), taa=settings)
