"""Port vs JAX: ray math, optical depth, v2 atmosphere, opaque pass, configs.

The same seeded numpy inputs go through each JAX function and its port
counterpart; the demo geometry comes from the JAX demo scene and is carried
across with ``models/convert.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models import params as jparams
from godot_atmosphere_shader_tpu.models.demo import build_demo_scene, demo_camera
from godot_atmosphere_shader_tpu.ops.atmosphere_v2 import compute_atmosphere_v2 as j_atmo
from godot_atmosphere_shader_tpu.ops.optical_depth import optical_depth_analytic as j_od
from godot_atmosphere_shader_tpu.render.opaque import render_opaque as j_opaque
from godot_atmosphere_shader_tpu.utils import camera as jcam
from godot_atmosphere_shader_tpu.utils import vecmath as jv
from godot_atmosphere_shader_tpu_torch.models import params as tparams
from godot_atmosphere_shader_tpu_torch.models.convert import (
    atmosphere_params_from_numpy, camera_from_numpy, opaque_from_numpy)
from godot_atmosphere_shader_tpu_torch.ops.atmosphere_v2 import compute_atmosphere_v2 as t_atmo
from godot_atmosphere_shader_tpu_torch.ops.optical_depth import optical_depth_analytic as t_od
from godot_atmosphere_shader_tpu_torch.render.opaque import render_opaque as t_opaque
from godot_atmosphere_shader_tpu_torch.utils import camera as tcam
from godot_atmosphere_shader_tpu_torch.utils import vecmath as tv

torch.set_num_threads(1)

SHAPE = (24, 32)


def _fields(obj):
    return {f.name: None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def demo():
    """JAX demo scene at the avatar pose, and its port twins by convert."""
    scene = build_demo_scene("clouds_high")
    cam = demo_camera("avatar")
    scene.update(0.5, cam)
    jp = scene.atmospheres[0].build_params().resolve_frame_state()
    tp = atmosphere_params_from_numpy(_fields(jp), device="cpu")
    return {"jp": jp, "tp": tp, "jcam": cam, "opaque": scene.opaque,
            "tcam": camera_from_numpy(_fields(cam), device="cpu"),
            "topaque": opaque_from_numpy(_fields(scene.opaque), device="cpu")}


def _rays(seed, origin_scale=150.0):
    """Seeded ray origins and unit directions as numpy (3, H, W)."""
    rng = np.random.default_rng(seed)
    o = ((rng.random((3,) + SHAPE) * 2 - 1) * origin_scale).astype(np.float32)
    d = rng.normal(size=(3,) + SHAPE)
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    return o, d


def _jv3(a):
    return jv.Vec3(*(jnp.asarray(c) for c in a))


def _tv3(a):
    return tv.Vec3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


@pytest.mark.parametrize("radius", [100.0, 108.0, 1000.0])
def test_ray_sphere(radius):
    o, d = _rays(1)
    c = np.array([3.0, -2.0, 1.0], np.float32)
    j0, j1 = jv.ray_sphere(_jv3(c), jnp.float32(radius), _jv3(o), _jv3(d))
    t0, t1 = tv.ray_sphere(_tv3(c), torch.tensor(radius), _tv3(o), _tv3(d))
    # miss sentinel and t0 != t1 hit test agree exactly
    np.testing.assert_array_equal((t0 != t1).numpy(), np.asarray(j0 != j1))
    np.testing.assert_allclose(t0.numpy(), np.asarray(j0), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol=1e-6, atol=1e-4)


def test_ray_box_with_axis_aligned_rays():
    o, d = _rays(2, origin_scale=30.0)
    d[:, 0, :4] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, 1], [-1, 0, 0]], np.float32).T
    half = np.full((3,) + SHAPE, 5.0, np.float32)
    half[1] = 15.0
    jn, jf, jh = jv.ray_box(_jv3(o), _jv3(d), _jv3(half))
    tn, tf, th = tv.ray_box(_tv3(o), _tv3(d), _tv3(half))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert np.isfinite(tn.numpy()).all()
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6, atol=1e-5)


def test_blend_colors_zero_alpha():
    rng = np.random.default_rng(3)
    a = [rng.random(SHAPE).astype(np.float32) for _ in range(8)]
    a[3][:2] = 0.0
    a[7][:2] = 0.0  # both alphas zero: transparent black
    jr, ja = jv.blend_colors(_jv3(a[:3]), jnp.asarray(a[3]), _jv3(a[4:7]), jnp.asarray(a[7]))
    tr, ta = tv.blend_colors(_tv3(a[:3]), torch.from_numpy(a[3]), _tv3(a[4:7]),
                             torch.from_numpy(a[7]))
    for j, t in zip(list(jr) + [ja], list(tr) + [ta]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("clamp_to_shell", [True, False])
def test_optical_depth_analytic(demo, clamp_to_shell):
    """Sun optical depth from sample points around the demo planet's shell,
    including points below the surface and above the atmosphere."""
    rng = np.random.default_rng(4)
    r = (95.0 + 16.0 * rng.random(SHAPE)).astype(np.float32)
    u = rng.normal(size=(3,) + SHAPE)
    pos = (u / np.linalg.norm(u, axis=0) * r).astype(np.float32)
    _, d = _rays(5)
    jp, tp = demo["jp"], demo["tp"]
    ref = np.asarray(j_od(_jv3(pos), _jv3(d), jv.Vec3(0.0, 0.0, 0.0), jp.planet_radius,
                          jp.atmosphere_height, jp.density, clamp_to_shell=clamp_to_shell))
    got = t_od(_tv3(pos), _tv3(d), tv.Vec3(0.0, 0.0, 0.0), tp.planet_radius,
               tp.atmosphere_height, tp.density, clamp_to_shell=clamp_to_shell).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_world_ray_dirs(demo):
    """The port builds rays from the host preamble (tan(fov/2) scale); the
    JAX XLA path from 1/tan: the two agree to f32 rounding."""
    h, w = SHAPE
    ref = jcam.world_ray_dirs(demo["jcam"], h, w)
    got = tcam.world_ray_dirs(demo["tcam"], h, w)
    for j, t in zip(ref, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


def test_compute_atmosphere_v2_demo_geometry(demo):
    """Camera rays through the demo shell from the avatar pose, marched over
    the same spans on both sides."""
    h, w = SHAPE
    jp, tp = demo["jp"], demo["tp"]
    rd = np.stack([np.asarray(c) for c in jcam.world_ray_dirs(demo["jcam"], h, w)])
    ro = np.asarray(demo["jcam"].view_to_world)[:3, 3]
    center = np.zeros(3, np.float32)
    t0, t1 = jv.ray_sphere(jv.Vec3(*center), jp.planet_radius + jp.atmosphere_height,
                           jv.Vec3(*(jnp.float32(v) for v in ro)), _jv3(rd))
    hit = np.asarray(t0 != t1)
    tb = np.where(hit, np.maximum(np.asarray(t0), 0), 0).astype(np.float32)
    te = np.where(hit, np.maximum(np.asarray(t1), 0), 0).astype(np.float32)
    jitter = np.random.default_rng(6).random(SHAPE, dtype=np.float32)
    sun = np.array([0.0, 0.0, 1.0], np.float32)
    jrgb, ja = j_atmo(jv.Vec3(*(jnp.float32(v) for v in ro)), _jv3(rd), jv.Vec3(*center),
                      jnp.asarray(tb), jnp.asarray(te), jv.Vec3(*sun), jnp.asarray(jitter),
                      jp, 8)
    trgb, ta = t_atmo(tv.Vec3(*(torch.tensor(float(v)) for v in ro)), _tv3(rd),
                      tv.Vec3(0.0, 0.0, 0.0), torch.from_numpy(tb), torch.from_numpy(te),
                      tv.Vec3(*(float(v) for v in sun)), torch.from_numpy(jitter), tp, 8)
    assert hit.any() and (~hit).any()
    for j, t in zip(list(jrgb) + [ja], list(trgb) + [ta]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


def test_lut_mode_not_ported(demo):
    """``od_mode="lut"`` is ported: without a LUT it raises ``ValueError``
    (as JAX), with the JAX bake it matches JAX's LUT march on the demo
    camera's rays at atol 1e-5."""
    from godot_atmosphere_shader_tpu.ops.optical_depth import bake_optical_depth

    z = torch.zeros(SHAPE)
    with pytest.raises(ValueError):
        t_atmo(tv.Vec3(0.0, 0.0, 0.0), tv.Vec3(z, z, z), tv.Vec3(0.0, 0.0, 0.0), z, z,
               tv.Vec3(1.0, 0.0, 0.0), z, demo["tp"], 8, od_mode="lut")
    h, w = SHAPE
    jp, tp = demo["jp"], demo["tp"]
    lut = np.array(bake_optical_depth(100.0, 8.0, 0.5, resolution=64))
    rd = np.stack([np.asarray(c) for c in jcam.world_ray_dirs(demo["jcam"], h, w)])
    ro = np.asarray(demo["jcam"].view_to_world)[:3, 3]
    t0, t1 = jv.ray_sphere(jv.Vec3(0.0, 0.0, 0.0), jp.planet_radius + jp.atmosphere_height,
                           jv.Vec3(*(jnp.float32(v) for v in ro)), _jv3(rd))
    hit = np.asarray(t0 != t1)
    tb = np.where(hit, np.maximum(np.asarray(t0), 0), 0).astype(np.float32)
    te = np.where(hit, np.maximum(np.asarray(t1), 0), 0).astype(np.float32)
    jitter = np.random.default_rng(7).random(SHAPE, dtype=np.float32)
    sun = np.array([0.0, 0.6, 0.8], np.float32)
    jrgb, ja = j_atmo(jv.Vec3(*(jnp.float32(v) for v in ro)), _jv3(rd), jv.Vec3(0.0, 0.0, 0.0),
                      jnp.asarray(tb), jnp.asarray(te), jv.Vec3(*sun), jnp.asarray(jitter),
                      jp, 8, od_mode="lut", lut=jnp.asarray(lut))
    trgb, ta = t_atmo(tv.Vec3(*(torch.tensor(float(v)) for v in ro)), _tv3(rd),
                      tv.Vec3(0.0, 0.0, 0.0), torch.from_numpy(tb), torch.from_numpy(te),
                      tv.Vec3(*(float(v) for v in sun)), torch.from_numpy(jitter), tp, 8,
                      od_mode="lut", lut=torch.from_numpy(lut))
    assert hit.any()
    for j, t in zip(list(jrgb) + [ja], list(trgb) + [ta]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("pose", ["avatar", "space"])
def test_render_opaque_demo_geometry(demo, pose):
    """The demo's spheres, tumbling box, light and starfield, given the same
    rays: color, nonlinear depth and linear depth."""
    h, w = SHAPE
    cam = demo_camera(pose)
    tc = camera_from_numpy(_fields(cam), device="cpu")
    rd = jcam.world_ray_dirs(cam, h, w)
    ref = j_opaque(demo["opaque"], cam, h, w, ray_dir=rd)
    got = t_opaque(demo["topaque"], tc, h, w, ray_dir=tv.Vec3(
        *(torch.from_numpy(np.array(c)) for c in rd)))
    for j, t in zip(list(ref[0]), list(got[0])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-6, atol=1e-5)


def _field_table(cls):
    out = []
    for f in dataclasses.fields(cls):
        default = f.default if f.default is not dataclasses.MISSING else (
            f.default_factory() if f.default_factory is not dataclasses.MISSING
            else dataclasses.MISSING)
        out.append((f.name, default))
    return out


def test_variant_config_fields_and_defaults_match_jax():
    assert _field_table(tparams.VariantConfig) == _field_table(jparams.VariantConfig)


def test_variants_and_profiles_match_jax():
    for table in ("VARIANTS", "PROFILES"):
        jt, tt = getattr(jparams, table), getattr(tparams, table)
        assert sorted(jt) == sorted(tt)
        for name in jt:
            assert dataclasses.asdict(tt[name]) == dataclasses.asdict(jt[name])


def test_atmosphere_params_fields_and_defaults_match_jax():
    assert ([f.name for f in dataclasses.fields(tparams.AtmosphereParams)]
            == [f.name for f in dataclasses.fields(jparams.AtmosphereParams)])
    ref = _fields(jparams.AtmosphereParams.create())
    got = _fields(tparams.AtmosphereParams.create(device="cpu"))
    for name, v in ref.items():
        if v is None:
            assert got[name] is None, name
        else:
            np.testing.assert_allclose(got[name], v, rtol=1e-6, atol=1e-7, err_msg=name)


def test_frame_state_pack_and_resolve(demo):
    fs = tparams.AtmosphereParams.pack_frame_state(
        (1.0, 2.0, 3.0), np.arange(16, dtype=np.float32).reshape(4, 4),
        np.array([[0.0, -1.0], [1.0, 0.0]]), 4.5)
    np.testing.assert_array_equal(fs, jparams.AtmosphereParams.pack_frame_state(
        (1.0, 2.0, 3.0), np.arange(16, dtype=np.float32).reshape(4, 4),
        np.array([[0.0, -1.0], [1.0, 0.0]]), 4.5))
    p = dataclasses.replace(demo["tp"], frame_state=torch.from_numpy(fs)).resolve_frame_state()
    assert p.frame_state is None
    np.testing.assert_array_equal(p.world_to_model.numpy(),
                                  np.arange(16, dtype=np.float32).reshape(4, 4))
    np.testing.assert_array_equal(p.sun_position.numpy(), [1.0, 2.0, 3.0])
    assert float(p.time) == 4.5


def test_jitter_plane_tiles_the_committed_asset():
    from godot_atmosphere_shader_tpu.render.jitter import jitter_plane as j_jitter
    from godot_atmosphere_shader_tpu_torch.render.jitter import jitter_plane as t_jitter

    for h, w in ((48, 64), (300, 520)):
        np.testing.assert_array_equal(t_jitter(h, w, device="cpu").numpy(),
                                      np.asarray(j_jitter(h, w)))


def test_missing_blue_noise_asset_raises(monkeypatch, tmp_path):
    from godot_atmosphere_shader_tpu_torch.render import jitter

    monkeypatch.setattr(jitter, "BLUE_NOISE_PATH", str(tmp_path / "missing.npy"))
    with pytest.raises(FileNotFoundError):
        jitter.jitter_plane(8, 8, device="cpu")
