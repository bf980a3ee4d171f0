"""The golden demo scene, node for node as the JAX package's
``models/demo.py``: planet R=100 with atmosphere H=8 and clouds, sun sphere
and light at z≈598.7, moon, tumbling box, and the named camera poses; and
the gas-giant scene (R=1000, H=25, 64 atmosphere steps) with its poses.

Two field modes, as in the JAX package: procedural fields evaluated in the
march (the fast profile), or the reference's asset pipeline — a 64³ shape
texture and a 256² coverage cubemap baked from the same noise specs
(:func:`bake_demo_textures`) and sampled through mip pyramids.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.noise import NoiseSpec
from ..ops.sampling import bake_noise_cubemap, bake_noise_texture3d
from ..render.opaque import OpaqueScene
from ..utils.camera import Camera, look_at
from ..utils.color import srgb_to_linear
from .params import PROFILES, VARIANTS, ProceduralField, VariantConfig
from .scene import Node3D, PlanetAtmosphere, Scene

#: the demo NoiseTexture3D source (planet_atmosphere_test.tscn:48-57):
#: cellular, ridged, 8 octaves, gain 0.665 — the shape-texture bake
SHAPE_NOISE_BAKE = NoiseSpec(noise_type="cellular", frequency=0.1,
                             fractal_type="ridged", octaves=8, gain=0.665,
                             cellular_return="distance", seed=3)
#: in-march cloud shape: value basis, ridged, 3 octaves (the demo's
#: NoiseTexture3D stand-in)
SHAPE_NOISE_FAST = NoiseSpec(noise_type="value", frequency=0.1,
                             fractal_type="ridged", octaves=3, gain=0.665,
                             seed=3)
#: the cellular quality tier of the in-march shape: the 8-cell Worley F1
#: window (``cellular_fast``, the bake's feature points), ridged, 3 octaves
SHAPE_NOISE_FAST_CELL = NoiseSpec(noise_type="cellular_fast", frequency=0.1,
                                  fractal_type="ridged", octaves=3, gain=0.665,
                                  cellular_return="distance", seed=3)
#: the in-march shape bases of ``demo_variant(shape_basis=)``
SHAPE_BASES = {"value": SHAPE_NOISE_FAST, "cellular": SHAPE_NOISE_FAST_CELL}
#: the demo NoiseCubemap: default FastNoiseLite with domain warp
COVERAGE_NOISE = NoiseSpec(noise_type="simplex_smooth", frequency=0.01,
                           fractal_type="fbm", octaves=5,
                           warp_enabled=True, warp_amplitude=90.0,
                           warp_frequency=0.01, warp_octaves=3, seed=11)
COVERAGE_SCALE = (100.0, 200.0, 100.0)
COVERAGE_RESOLUTION = 256
SHAPE_TEXTURE_SIZE = 64


def demo_variant(name: str = "clouds", procedural: bool = True,
                 shape_basis: str = "value") -> VariantConfig:
    """The demo's shader variant with its fast profile: 8 coverage knots,
    coverage and cloud LOD 2, interior LOD 4, dynamic knots; procedural
    field specs, or none with ``procedural=False`` (baked textures).
    ``shape_basis``: the in-march shape, ``"value"`` (the fast spec) or
    ``"cellular"`` (``SHAPE_NOISE_FAST_CELL``)."""
    cfg = VARIANTS[name]
    if not cfg.clouds_enabled:
        return cfg
    profile = dict(cloud_coverage_interp=True, cloud_coverage_knots=8,
                   cloud_coverage_lod=2, cloud_lod=2, cloud_lod_interior=4,
                   knot_dynamic=True)
    if not procedural:
        return dataclasses.replace(cfg, **profile)
    return dataclasses.replace(
        cfg,
        cloud_shape_noise=ProceduralField(
            noise=SHAPE_BASES[shape_basis], scale=(float(SHAPE_TEXTURE_SIZE),) * 3),
        cloud_coverage_noise=ProceduralField(
            noise=COVERAGE_NOISE, scale=COVERAGE_SCALE),
        **profile)


def bake_demo_textures(*, device="cuda", shape_size: int = SHAPE_TEXTURE_SIZE,
                       cubemap_size: int = COVERAGE_RESOLUTION):
    """The demo's baked assets on ``device``: the ``(S, S, S)`` shape texture
    (``SHAPE_NOISE_BAKE``, seamless) and the ``(6, R, R)`` coverage cubemap
    (``COVERAGE_NOISE`` at ``COVERAGE_SCALE``)."""
    return (bake_noise_texture3d(SHAPE_NOISE_BAKE, shape_size, device=device),
            bake_noise_cubemap(COVERAGE_NOISE, COVERAGE_SCALE, cubemap_size,
                               device=device))


def build_demo_scene(variant: str = "clouds", procedural: bool = True,
                     shape_basis: str = "value", *, device="cuda", textures=None) -> Scene:
    """Planet + sun + moon + cube demo scene on ``device``.  With
    ``procedural=False`` a clouds variant samples baked textures:
    ``textures`` = ``(shape, cubemap)`` if given (e.g. carried across from
    the JAX package), else :func:`bake_demo_textures` on ``device``;
    ``shape_basis`` as in :func:`demo_variant`."""
    sun = Node3D(position=(0.0, 0.0, 598.677), name="Sun")
    atmo = PlanetAtmosphere(
        planet_radius=100.0, atmosphere_height=8.0, sun=sun,
        custom_shader=demo_variant(variant, procedural, shape_basis),
        name="PlanetAthmosphere",  # sic, as in the tscn
        device=device)
    # shader_params block (planet_atmosphere_test.tscn:101-114)
    atmo.set_shader_parameter("u_density", 0.5)
    atmo.set_shader_parameter("u_scattering_strength", 1.0)
    atmo.set_shader_parameter("u_atmosphere_modulate", (1.0, 0.980392, 0.964706))
    atmo.set_shader_parameter("u_atmosphere_ambient_color",
                              (0.0196078, 0.0196078, 0.0431373))
    atmo.set_shader_parameter("u_cloud_density_scale", 2.0)
    atmo.set_shader_parameter("u_cloud_bottom", 0.2)
    atmo.set_shader_parameter("u_cloud_top", 0.6)
    atmo.set_shader_parameter("u_cloud_blend", 0.5)
    atmo.set_shader_parameter("u_cloud_shape_invert", 1.0)
    atmo.set_shader_parameter("u_cloud_coverage_bias", 0.0)
    atmo.set_shader_parameter("u_cloud_shape_factor", 0.5)
    atmo.set_shader_parameter("u_cloud_shape_scale", 0.1)
    if not procedural and atmo.config.clouds_enabled:
        shape, cubemap = textures if textures is not None else bake_demo_textures(device=device)
        atmo.set_shader_parameter("u_cloud_shape_texture", shape)
        atmo.set_shader_parameter("u_cloud_coverage_cubemap", cubemap)

    # opaque geometry (planet_atmosphere_test.tscn:78-125)
    ground_albedo = tuple(srgb_to_linear(
        np.array([0.27451, 0.364706, 0.431373], np.float32), device="cpu").tolist())
    box_transform_world = np.array([
        [0.737148, 2.23517e-08, -0.675732, 74.2016],
        [0.662773, 0.194902, 0.723011, 13.2348],
        [0.131701, -0.980823, 0.143672, 80.2044],
        [0.0, 0.0, 0.0, 1.0],
    ], np.float32)
    r = box_transform_world[:3, :3]
    t = box_transform_world[:3, 3]
    w2b = np.eye(4, dtype=np.float32)
    w2b[:3, :3] = r.T
    w2b[:3, 3] = -(r[0] * t[0] + r[1] * t[1] + r[2] * t[2])  # -Rᵀt

    opaque = OpaqueScene.create(
        spheres=[
            ((0.0, 0.0, 0.0), 100.0, ground_albedo),  # Ground
            ((0.0, 0.0, 598.677), 20.0, (4.0, 4.0, 4.0), 1.0),  # Sun (unshaded)
            ((-188.991, 0.0, 192.584), 10.0, (0.6, 0.6, 0.6)),  # Moon
        ],
        boxes=[(w2b, (5.0, 15.0, 5.0), (0.7, 0.7, 0.7))],
        light_dir=(0.0, 0.0, -1.0),
        ambient=0.02,
        sky_color=(0.001, 0.001, 0.002),
        star_intensity=1.0,
        device=device,
    )
    return Scene(atmospheres=[atmo], opaque=opaque, device=device)


def default_node_scene(*, device="cuda") -> Scene:
    """The drag-and-drop default node scene (``planet_atmosphere.tscn:8-15``):
    R = 1, H = 0.2, the built-in v2 no-clouds shader, density 10, scattering
    strength 0.5, on ``device``."""
    atmo = PlanetAtmosphere(planet_radius=1.0, atmosphere_height=0.2,
                            custom_shader="no_clouds", device=device)
    atmo.set_shader_parameter("u_density", 10.0)
    atmo.set_shader_parameter("u_scattering_strength", 0.5)
    return Scene(atmospheres=[atmo], device=device)


_POSES = {
    "avatar": ((0.0, 0.0, 156.425), (0.0, 0.0, 0.0)),  # flying-avatar start
    "exterior": ((180.0, 60.0, 180.0), (0.0, 0.0, 0.0)),
    "interior": ((0.0, 104.0, 0.0), (100.0, 100.0, 0.0)),  # inside the shell
    "space": ((0.0, 150.0, 420.0), (0.0, 0.0, 0.0)),
    "sunrise": ((0.0, 103.0, 0.0), (0.0, 30.0, 598.677)),
    "sunward": ((0.0, 130.0, 300.0), (0.0, 0.0, 598.677)),
}


def demo_camera(pose: str = "avatar", *, device="cuda") -> Camera:
    """Named camera poses of the demo (70° fov, near 0.1, far 800)."""
    if pose not in _POSES:
        raise ValueError(f"unknown pose {pose!r}")
    eye, target = _POSES[pose]
    return Camera.create(look_at(eye, target, device=device), fov_y_deg=70.0,
                         near=0.1, far=800.0, device=device)


def build_gas_giant_scene(*, device="cuda") -> Scene:
    """The gas-giant scene on ``device`` (``PROFILES['gas_giant']``, 64
    atmosphere steps): R/H = 40 (R=1000, H=25) with ``u_density = 2.0``,
    optically thick, no clouds; an opaque R=1000 deck below the shell and
    the sun at z≈5986.8."""
    sun = Node3D(position=(0.0, 0.0, 5986.77), name="Sun")
    atmo = PlanetAtmosphere(planet_radius=1000.0, atmosphere_height=25.0, sun=sun,
                            custom_shader=PROFILES["gas_giant"], name="GasGiant",
                            device=device)
    atmo.set_shader_parameter("u_density", 2.0)
    atmo.set_shader_parameter("u_scattering_strength", 1.0)
    atmo.set_shader_parameter("u_atmosphere_modulate", (1.0, 0.95, 0.85))
    atmo.set_shader_parameter("u_atmosphere_ambient_color", (0.02, 0.015, 0.01))
    deck_albedo = tuple(srgb_to_linear(
        np.array([0.76, 0.64, 0.47], np.float32), device="cpu").tolist())
    opaque = OpaqueScene.create(
        spheres=[
            ((0.0, 0.0, 0.0), 1000.0, deck_albedo),  # opaque deck
            ((0.0, 0.0, 5986.77), 200.0, (4.0, 4.0, 4.0), 1.0),  # sun
        ],
        light_dir=(0.0, 0.0, -1.0),
        ambient=0.02,
        sky_color=(0.001, 0.001, 0.002),
        star_intensity=1.0,
        device=device,
    )
    return Scene(atmospheres=[atmo], opaque=opaque, device=device)


_GAS_GIANT_POSES = {
    # every ray through the shell is a full-traversal, optically thick chord
    "limb": ((0.0, 0.0, 3000.0), (0.0, 1012.0, 0.0)),
    "exterior": ((1800.0, 600.0, 1800.0), (0.0, 0.0, 0.0)),
    "interior": ((0.0, 1020.0, 0.0), (1000.0, 1012.0, 0.0)),
    "space": ((0.0, 1500.0, 4200.0), (0.0, 0.0, 0.0)),
}


def gas_giant_camera(pose: str = "limb", *, device="cuda") -> Camera:
    """Named poses of the gas-giant scene (70° fov, near 1, far 8000)."""
    if pose not in _GAS_GIANT_POSES:
        raise ValueError(f"unknown gas-giant pose {pose!r}")
    eye, target = _GAS_GIANT_POSES[pose]
    return Camera.create(look_at(eye, target, device=device), fov_y_deg=70.0,
                         near=1.0, far=8000.0, device=device)
