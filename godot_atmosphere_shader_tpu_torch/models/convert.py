"""Carry weights and state across from the JAX package.

The port imports no JAX type: callers hand over each object as a
``{field_name: np.ndarray}`` mapping (``np.asarray`` of every field), and
these builders make the port's tensors on an explicit device.  The same
mappings come back out of :func:`to_numpy`, so a round trip is exact.
:func:`scene_from_numpy` carries a whole scene across: its layers (node
properties, config, params and a baked optical-depth LUT), an opaque scene
of any sphere and box count, and its ``large_world`` setting.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from ..ops.kernels.texsample import TexMeta
from ..ops.noise import NoiseSpec
from ..render.opaque import OpaqueScene
from ..utils.camera import Camera
from .params import AtmosphereParams, ProceduralField, VariantConfig
from .scene import Node3D, PlanetAtmosphere, Scene


def _tensor(v, device):
    return torch.tensor(np.asarray(v, np.float32), device=device)


def _build(cls, fields: Mapping[str, np.ndarray], device):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(fields) - names
    if unknown:
        raise KeyError(f"{cls.__name__} has no field(s) {sorted(unknown)}")
    return cls(**{k: None if v is None else _tensor(v, device)
                  for k, v in fields.items()})


def atmosphere_params_from_numpy(fields: Mapping[str, np.ndarray], *,
                                 device) -> AtmosphereParams:
    """AtmosphereParams from its fields, the baked ``cloud_shape_texture``
    (S³) and ``cloud_coverage_cubemap`` (6, R, R) included; ``None`` fields
    stay ``None``."""
    return _build(AtmosphereParams, fields, device)


def camera_from_numpy(fields: Mapping[str, np.ndarray], *, device) -> Camera:
    """Camera from ``view_to_world``, ``fov_y_rad``, ``near`` and ``far``."""
    return _build(Camera, fields, device)


def opaque_from_numpy(fields: Mapping[str, np.ndarray], *, device) -> OpaqueScene:
    """OpaqueScene from its stacked arrays and its panorama (or None)."""
    return _build(OpaqueScene, fields, device)


def to_numpy(obj) -> dict:
    """``{field_name: np.ndarray}`` of a port object (None stays None)."""
    return {f.name: (None if getattr(obj, f.name) is None
                     else getattr(obj, f.name).detach().cpu().numpy())
            for f in dataclasses.fields(obj)}


def variant_config_from_fields(fields: Mapping) -> VariantConfig:
    """VariantConfig from ``dataclasses.asdict`` of a JAX config (nested
    procedural-field specs and pyramid metas included; a meta becomes the
    port's own :class:`TexMeta`)."""
    fields = dict(fields)
    for key in ("cloud_shape_noise", "cloud_coverage_noise"):
        spec = fields.get(key)
        if spec is not None:
            fields[key] = ProceduralField(noise=NoiseSpec(**spec["noise"]),
                                          scale=tuple(spec["scale"]))
    for key in ("cloud_shape_tex_meta", "cloud_coverage_tex_meta"):
        meta = fields.get(key)
        if meta is not None:
            fields[key] = TexMeta(kind=meta["kind"], rows=int(meta["rows"]),
                                  levels=tuple(tuple(int(v) for v in lv)
                                               for lv in meta["levels"]))
    return VariantConfig(**fields)


def scene_from_numpy(layers, opaque: Mapping = None, *, large_world=None, environment=None,
                     device) -> Scene:
    """A ``Scene`` on ``device`` from a JAX scene's parts.  ``layers``: per
    atmosphere a mapping with ``"node"`` (``planet_radius``,
    ``atmosphere_height``, ``transform``, ``clouds_rotation_speed``,
    ``force_fullscreen``, ``name`` and, where it has a sun,
    ``sun_transform``), ``"config"`` (``dataclasses.asdict`` of its
    ``VariantConfig``) and ``"params"`` (:func:`atmosphere_params_from_numpy`'s
    mapping; an ``optical_depth_lut`` there is the layer's baked LUT, kept
    as its LUT cache's entry for its radius, height and density, so the
    port does not bake its own); ``opaque``: :func:`opaque_from_numpy`'s
    mapping, any number of spheres and boxes; ``large_world`` and
    ``environment`` as the scene's."""
    atmospheres = []
    for layer in layers:
        node = layer["node"]
        sun = node.get("sun_transform")
        atmo = PlanetAtmosphere(
            planet_radius=float(node["planet_radius"]),
            atmosphere_height=float(node["atmosphere_height"]),
            sun=None if sun is None else Node3D(transform=np.asarray(sun, np.float64)),
            custom_shader=variant_config_from_fields(layer["config"]),
            clouds_rotation_speed=float(node.get("clouds_rotation_speed", 1.0)),
            force_fullscreen=bool(node.get("force_fullscreen", False)),
            transform=np.asarray(node["transform"], np.float64),
            name=str(node.get("name", "PlanetAtmosphere")), device=device)
        fields = dict(layer["params"])
        lut = fields.pop("optical_depth_lut", None)
        params = atmosphere_params_from_numpy(fields, device=device)
        atmo._params = params
        atmo._density = float(np.float32(fields["density"]))
        atmo._sun_position_host = np.asarray(fields["sun_position"], np.float32)
        if lut is not None:
            key = (atmo._radius, atmo._height, atmo._density)
            atmo._lut_cache._cache[key] = _tensor(lut, device)
        atmospheres.append(atmo)
    return Scene(atmospheres, None if opaque is None else opaque_from_numpy(opaque, device=device),
                 large_world=large_world, environment=environment, device=device)
