"""Carry weights and state across from the JAX package.

The port imports no JAX type: callers hand over each object as a
``{field_name: np.ndarray}`` mapping (``np.asarray`` of every field), and
these builders make the port's tensors on an explicit device.  The same
mappings come back out of :func:`to_numpy`, so a round trip is exact.
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
