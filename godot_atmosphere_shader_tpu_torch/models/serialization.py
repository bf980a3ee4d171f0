"""Scene serialization: the ``.tscn`` tier of the reference's config
system, as JSON.

Counterpart of ``godot_atmosphere_shader_tpu/models/serialization.py``:
a scene round-trips through a plain JSON-able dict with the reference's
``shader_params/u_*`` naming (``planet_atmosphere_test.tscn:96-114``), in
the JAX package's format, so a file written by either package loads in the
other.  Textures are never serialized (``noise_cubemap.gd:84-90``).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..ops.noise import NoiseSpec
from ..render.opaque import OpaqueScene
from .params import ProceduralField, VariantConfig
from .scene import _API_SHADER_PARAMS, _UNIFORM_TO_FIELD, Node3D, PlanetAtmosphere, Scene

_TEXTURE_FIELDS = ("cloud_shape_texture", "cloud_coverage_cubemap", "optical_depth_lut")
_OPAQUE_FIELDS = ("sphere_centers", "sphere_radii", "sphere_albedos", "sphere_unshaded",
                  "box_world_to_box", "box_half_sizes", "box_albedos", "light_dir", "ambient",
                  "sky_color", "star_intensity")


def _variant_to_dict(cfg: VariantConfig) -> dict:
    d = dataclasses.asdict(cfg)
    for key in ("cloud_shape_noise", "cloud_coverage_noise"):
        field = getattr(cfg, key)
        if field is not None:
            d[key] = {"noise": dataclasses.asdict(field.noise), "scale": list(field.scale)}
    return d


def _variant_from_dict(d: dict) -> VariantConfig:
    d = dict(d)
    for key in ("cloud_shape_noise", "cloud_coverage_noise"):
        if d.get(key) is not None:
            d[key] = ProceduralField(noise=NoiseSpec(**d[key]["noise"]),
                                     scale=tuple(d[key]["scale"]))
    return VariantConfig(**d)


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def atmosphere_to_dict(atmo: PlanetAtmosphere) -> dict:
    """One node: its exported properties and its shader params (colors as
    sRGB, as the reference's getter returns them)."""
    out = {
        "planet_radius": atmo.planet_radius,
        "atmosphere_height": atmo.atmosphere_height,
        "clouds_rotation_speed": atmo.clouds_rotation_speed,
        "force_fullscreen": atmo.force_fullscreen,
        "transform": np.asarray(atmo.transform).tolist(),
        "custom_shader": _variant_to_dict(atmo.config),
        "shader_params": {},
    }
    for uname, field in _UNIFORM_TO_FIELD.items():
        if uname in _API_SHADER_PARAMS or field in _TEXTURE_FIELDS:
            continue
        arr = _host(atmo.get_shader_parameter(uname))
        out["shader_params"][uname] = arr.tolist() if arr.ndim else float(arr)
    if atmo.sun is not None:
        out["sun_position"] = np.asarray(atmo.sun.position).tolist()
    return out


def atmosphere_from_dict(d: dict, *, device="cuda") -> PlanetAtmosphere:
    sun = None
    if "sun_position" in d:
        sun = Node3D(position=tuple(d["sun_position"]), name="Sun")
    atmo = PlanetAtmosphere(
        planet_radius=d["planet_radius"], atmosphere_height=d["atmosphere_height"], sun=sun,
        custom_shader=_variant_from_dict(d["custom_shader"]),
        clouds_rotation_speed=d.get("clouds_rotation_speed", 1.0),
        force_fullscreen=d.get("force_fullscreen", False),
        transform=np.asarray(d["transform"], np.float32), device=device)
    for uname, value in d.get("shader_params", {}).items():
        # the setter converts colors sRGB → linear, as they were written
        atmo.set_shader_parameter(uname, value)
    return atmo


def opaque_to_dict(op: OpaqueScene) -> dict:
    return {k: _host(getattr(op, k)).tolist() for k in _OPAQUE_FIELDS}


def opaque_from_dict(d: dict, *, device="cuda") -> OpaqueScene:
    """The opaque scene as tensors on ``device``."""
    return OpaqueScene(**{k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                          for k, v in d.items()})


def save_scene(scene: Scene, path: str) -> None:
    doc = {"atmospheres": [atmosphere_to_dict(a) for a in scene.atmospheres]}
    if scene.opaque is not None:
        doc["opaque"] = opaque_to_dict(scene.opaque)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)


def load_scene(path: str, *, device="cuda") -> Scene:
    """A saved scene on ``device`` (the card unless the caller asks for the
    CPU)."""
    with open(path) as f:
        doc = json.load(f)
    opaque = opaque_from_dict(doc["opaque"], device=device) if "opaque" in doc else None
    return Scene(atmospheres=[atmosphere_from_dict(d, device=device) for d in doc["atmospheres"]],
                 opaque=opaque, device=device)
