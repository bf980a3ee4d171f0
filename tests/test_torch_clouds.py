"""Port vs JAX: ``render_clouds_lod`` with the demo's procedural profile.

Same seeded inputs on both sides (albedo, alpha and jitter from numpy; rays
and depth from the JAX demo camera and opaque pass).  Cloud tolerance, as
knife-edge noise cells flip on ulp-level input differences: p99.9 |Δ| ≤ 1e-3,
mean |Δ| ≤ 1e-4, at most 0.1 % of pixels above 1e-2.

The JAX side runs with ``cull=False`` (eagerly, a few seconds, instead of a
~30 s compile of the culled graph): the cull is output-equivalent by
construction — a culled pixel marches to exact zeros — and
``test_cull_is_output_equivalent`` holds the port to that.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models.demo import build_demo_scene, demo_camera
from godot_atmosphere_shader_tpu.ops import clouds as jc
from godot_atmosphere_shader_tpu.render import atmosphere_pass as jpass
from godot_atmosphere_shader_tpu.render.opaque import render_opaque
from godot_atmosphere_shader_tpu.utils.camera import world_ray_dirs
from godot_atmosphere_shader_tpu.utils.vecmath import Vec3 as JVec3
from godot_atmosphere_shader_tpu_torch.models.convert import (
    atmosphere_params_from_numpy, variant_config_from_fields)
from godot_atmosphere_shader_tpu_torch.ops import clouds as tc
from godot_atmosphere_shader_tpu_torch.render import atmosphere_pass as tpass
from godot_atmosphere_shader_tpu_torch.utils.vecmath import Vec3 as TVec3

torch.set_num_threads(1)

H, W = 32, 64


def cloud_stats(got, ref):
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    return {"p999": float(np.percentile(d, 99.9)), "mean": float(d.mean()),
            "frac_above_1e-2": float((d.max(axis=-1) > 1e-2).mean())}


def assert_cloud_tolerance(got, ref):
    st = cloud_stats(got, ref)
    assert st["p999"] <= 1e-3 and st["mean"] <= 1e-4 and st["frac_above_1e-2"] <= 1e-3, st


def _inputs(pose, knot_dynamic):
    scene = build_demo_scene("clouds_high")
    cam = demo_camera(pose)
    scene.update(0.5, cam)
    atmo = scene.atmospheres[0]
    jp = atmo.build_params().resolve_frame_state()
    jcfg = dataclasses.replace(atmo.config, knot_dynamic=knot_dynamic)
    rd = world_ray_dirs(cam, H, W)
    _, _, ld = render_opaque(scene.opaque, cam, H, W, ray_dir=rd)
    rng = np.random.default_rng(12)
    planes = [rng.random((H, W), dtype=np.float32) for _ in range(5)]
    sun = np.asarray(jp.sun_position, np.float64)
    sun = (sun / np.linalg.norm(sun)).astype(np.float32)  # planet at the origin
    ro = np.asarray(cam.view_to_world)[:3, 3]
    return {
        "jp": jp, "jcfg": jcfg, "planes": planes, "sun": sun, "ro": ro,
        "rd": [np.array(c) for c in rd], "ld": np.array(ld),
        "tp": atmosphere_params_from_numpy(
            {f.name: None if getattr(jp, f.name) is None else np.asarray(getattr(jp, f.name))
             for f in dataclasses.fields(jp)}, device="cpu"),
        "tcfg": variant_config_from_fields(dataclasses.asdict(jcfg)),
    }


def _run_jax(d, lod):
    jp, cfg, p = d["jp"], d["jcfg"], d["planes"]
    rgb, a = jc.render_clouds_lod(
        JVec3(*(jnp.asarray(x) for x in p[:3])), jnp.asarray(p[3]), JVec3(0.0, 0.0, 0.0),
        JVec3(*(jnp.float32(v) for v in d["ro"])), JVec3(*(jnp.asarray(c) for c in d["rd"])),
        jnp.asarray(d["ld"]), jp.world_to_model, JVec3(*(float(v) for v in d["sun"])),
        jnp.asarray(p[4]), jp.time, jp, jpass.make_shape_fn(cfg, jp),
        jpass.make_coverage_fn(cfg, jp), cfg.cloud_steps, cfg.raymarched_lighting,
        cfg.clouds_always_low_quality, lod, coverage_interp=cfg.cloud_coverage_interp,
        cull=False, coverage_knots=cfg.cloud_coverage_knots,
        coverage_lod=cfg.cloud_coverage_lod, knot_dynamic=cfg.knot_dynamic)
    return np.stack([np.asarray(c) for c in list(rgb) + [a]], axis=-1)


def _run_torch(d, lod, cull=True):
    tp, cfg, p = d["tp"], d["tcfg"], d["planes"]
    rgb, a = tc.render_clouds_lod(
        TVec3(*(torch.from_numpy(x) for x in p[:3])), torch.from_numpy(p[3]),
        TVec3(0.0, 0.0, 0.0), TVec3(*(torch.tensor(float(v)) for v in d["ro"])),
        TVec3(*(torch.from_numpy(c) for c in d["rd"])), torch.from_numpy(d["ld"]),
        tp.world_to_model, TVec3(*(float(v) for v in d["sun"])), torch.from_numpy(p[4]),
        tp.time, tp, tpass.make_shape_fn(cfg, tp), tpass.make_coverage_fn(cfg, tp),
        cfg.cloud_steps, cfg.raymarched_lighting, cfg.clouds_always_low_quality, lod,
        coverage_interp=cfg.cloud_coverage_interp, cull=cull,
        coverage_knots=cfg.cloud_coverage_knots, coverage_lod=cfg.cloud_coverage_lod,
        knot_dynamic=cfg.knot_dynamic)
    return torch.stack(list(rgb) + [a], dim=-1).numpy()


@pytest.mark.parametrize("lod,pose,knot_dynamic", [
    (2, "avatar", True), (4, "interior", True), (4, "avatar", True),
    (2, "interior", False)])
def test_render_clouds_lod_matches_jax(lod, pose, knot_dynamic):
    d = _inputs(pose, knot_dynamic)
    ref = _run_jax(d, lod)
    got = _run_torch(d, lod)
    assert np.isfinite(got).all()
    # the clouds must actually be there for the comparison to mean anything
    assert np.abs(got - np.stack(d["planes"][:4], axis=-1)).max() > 0.05
    assert_cloud_tolerance(got, ref)


def test_cull_is_output_equivalent():
    d = _inputs("avatar", True)
    np.testing.assert_array_equal(_run_torch(d, 2, cull=True), _run_torch(d, 2, cull=False))


def test_row_count_must_divide_the_lod():
    d = _inputs("avatar", True)
    z = torch.zeros((H - 2, W))
    with pytest.raises(ValueError):
        tc.render_clouds_lod(TVec3(z, z, z), z, TVec3(0.0, 0.0, 0.0), TVec3(0.0, 0.0, 150.0),
                             TVec3(z, z, z), z, d["tp"].world_to_model,
                             TVec3(0.0, 0.0, 1.0), z, d["tp"].time, d["tp"], None, None,
                             64, False, True, 4, coverage_interp=True, coverage_lod=2)


def test_unported_cloud_features_raise():
    """Every cloud feature is ported (the detail field per step and from its
    knots: tests/test_torch_envelope.py); a shape or coverage field with
    neither a spec nor a texture is a user error, as in JAX."""
    d = _inputs("avatar", True)
    for change, make in ((dict(cloud_shape_noise=None), tpass.make_shape_fn),
                         (dict(cloud_coverage_noise=None), tpass.make_coverage_fn)):
        with pytest.raises(ValueError):
            make(dataclasses.replace(d["tcfg"], **change), d["tp"])
