"""Port vs JAX: the v1 "lite" atmosphere (``ops/atmosphere_v1.py``).

Seeded rays through the demo shell from the exterior pose and seeded rays
from random origins, marched over the same spans on both sides; the v1
colors are the demo's ``v1_no_clouds`` layer's (the shader's declared
defaults, sRGB → linear) and a seeded set.  Cloud-free tolerance: atol
1e-5 with rtol 1e-4 (``tests/test_pallas.py:38``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models.demo import build_demo_scene, demo_camera
from godot_atmosphere_shader_tpu.ops.atmosphere_v1 import compute_atmosphere_v1 as j_v1
from godot_atmosphere_shader_tpu.utils import camera as jcam
from godot_atmosphere_shader_tpu.utils import vecmath as jv
from godot_atmosphere_shader_tpu_torch.models.convert import atmosphere_params_from_numpy
from godot_atmosphere_shader_tpu_torch.ops.atmosphere_v1 import compute_atmosphere_v1 as t_v1
from godot_atmosphere_shader_tpu_torch.utils import vecmath as tv

torch.set_num_threads(1)

SHAPE = (32, 48)


def _fields(obj):
    return {f.name: None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def v1_params():
    scene = build_demo_scene("v1_no_clouds")
    cam = demo_camera("exterior")
    scene.update(0.5, cam)
    jp = scene.atmospheres[0].build_params().resolve_frame_state()
    return jp, cam


def _spans(jp, ro, rd):
    """The shell spans, ended at the ground as the frame's opaque ground
    sphere ends them (the v1 factor is not bounded through the planet)."""
    o, d = jv.Vec3(*(jnp.asarray(c) for c in ro)), jv.Vec3(*(jnp.asarray(c) for c in rd))
    t0, t1 = jv.ray_sphere(jv.Vec3(0.0, 0.0, 0.0), jp.planet_radius + jp.atmosphere_height, o, d)
    g0, g1 = jv.ray_sphere(jv.Vec3(0.0, 0.0, 0.0), jp.planet_radius, o, d)
    hit = np.asarray(t0 != t1)
    ground = np.where(np.asarray(g0 != g1) & (np.asarray(g1) > 0), np.asarray(g0), 1e7)
    tb = np.where(hit, np.maximum(np.asarray(t0), 0), 0).astype(np.float32)
    te = np.where(hit, np.maximum(np.minimum(np.asarray(t1), ground), tb), 0).astype(np.float32)
    return hit, tb, te


def _compare(jp, ro, rd, tb, te, sun):
    tp = atmosphere_params_from_numpy(_fields(jp), device="cpu")
    jrgb, ja = j_v1(jv.Vec3(*(jnp.asarray(c) for c in ro)), jv.Vec3(*(jnp.asarray(c) for c in rd)),
                    jv.Vec3(0.0, 0.0, 0.0), jnp.asarray(tb), jnp.asarray(te), jv.Vec3(*sun), jp, 16)
    trgb, ta = t_v1(tv.Vec3(*(torch.as_tensor(np.asarray(c, np.float32)) for c in ro)),
                    tv.Vec3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in rd)),
                    tv.Vec3(0.0, 0.0, 0.0), torch.from_numpy(tb), torch.from_numpy(te),
                    tv.Vec3(*(float(v) for v in sun)), tp, 16)
    for j, t in zip(list(jrgb) + [ja], list(trgb) + [ta]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-5)
    return np.stack([t.numpy() for t in list(trgb) + [ta]], -1)


def test_v1_demo_geometry(v1_params):
    """Camera rays through the demo shell from the exterior pose."""
    jp, cam = v1_params
    h, w = SHAPE
    rd = np.stack([np.asarray(c) for c in jcam.world_ray_dirs(cam, h, w)])
    ro = [np.float32(v) for v in np.asarray(cam.view_to_world)[:3, 3]]
    hit, tb, te = _spans(jp, [np.full(SHAPE, v, np.float32) for v in ro], rd)
    sun = np.asarray(jp.sun_position, np.float64)
    sun = (sun / np.linalg.norm(sun)).astype(np.float32)
    out = _compare(jp, ro, rd, tb, te, sun)
    assert hit.any() and (~hit).any() and out[..., 3].max() > 0.1


@pytest.mark.parametrize("seed", [3, 4])
def test_v1_seeded_rays_and_colors(v1_params, seed):
    """Random origins in the shell and above it, random directions and a
    seeded color set and transition scale."""
    jp, _ = v1_params
    rng = np.random.default_rng(seed)
    ro = rng.normal(size=(3,) + SHAPE)
    ro = (ro / np.linalg.norm(ro, axis=0) * rng.uniform(102.0, 160.0, SHAPE)).astype(np.float32)
    rd = rng.normal(size=(3,) + SHAPE)
    rd = (rd / np.linalg.norm(rd, axis=0)).astype(np.float32)
    colors = {k: jnp.asarray(rng.random(3, dtype=np.float32))
              for k in ("day_color0", "day_color1", "night_color0", "night_color1")}
    jp = dataclasses.replace(jp, day_night_transition_scale=jnp.float32(rng.uniform(0.5, 4.0)),
                             **colors)
    hit, tb, te = _spans(jp, ro, rd)
    sun = rng.normal(size=3)
    sun = (sun / np.linalg.norm(sun)).astype(np.float32)
    _compare(jp, ro, rd, tb, te, sun)
    assert hit.mean() > 0.2
