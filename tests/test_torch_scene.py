"""The slice as a whole: the port's ``Scene`` against the JAX ``Scene``.

Both packages build the demo scene their own way, update it at t = 0.5 and
render 48×64 on the CPU (the port: its plain version; JAX: its XLA path).
Cloud tolerance: p99.9 |Δ| ≤ 1e-3, mean |Δ| ≤ 1e-4, at most 0.1 % of pixels
above 1e-2.  Also: the ``models/convert.py`` round trip, the near/far and
interior-LOD switches along a camera path, far-mode and multi-layer frames,
what ``Scene.render`` refuses, and that the port package never imports
JAX.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models import demo as jdemo
from godot_atmosphere_shader_tpu_torch.models import convert
from godot_atmosphere_shader_tpu_torch.models import demo as tdemo
from godot_atmosphere_shader_tpu_torch.models import scene as tscene
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

torch.set_num_threads(2)

H, W = 48, 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_frame(pose):
    scene = jdemo.build_demo_scene("clouds_high")
    cam = jdemo.demo_camera(pose)
    scene.update(0.5, cam)
    out = scene.render(cam, H, W)
    img = np.concatenate([np.asarray(out["color"]), np.asarray(out["alpha"])[..., None]], -1)
    return img, scene.atmospheres[0].effective_config().cloud_lod


def _port_frame(pose):
    scene = tdemo.build_demo_scene("clouds_high", device="cpu")
    cam = tdemo.demo_camera(pose, device="cpu")
    scene.update(0.5, cam)
    mk.counters.reset()
    out = scene.render(cam, H, W)
    assert mk.counters.plain_calls == 1 and mk.counters.megakernel_launches == 0
    assert set(out) == {"color", "alpha"}  # the same keys the kernel returns
    img = torch.cat([out["color"], out["alpha"][..., None]], dim=-1).numpy()
    return img, scene.atmospheres[0].effective_config().cloud_lod


@pytest.fixture(scope="module")
def jax_frames():
    return {pose: _jax_frame(pose) for pose in ("avatar", "interior")}


@pytest.mark.parametrize("pose,lod", [("avatar", 2), ("interior", 4)])
def test_scene_render_matches_jax(jax_frames, pose, lod):
    ref, ref_lod = jax_frames[pose]
    got, got_lod = _port_frame(pose)
    assert ref_lod == got_lod == lod  # the interior LOD engages on both sides
    assert np.isfinite(got).all()
    assert 0.0 <= got[..., 3].min() and got[..., 3].max() <= 1.0
    d = np.abs(got.astype(np.float64) - ref)
    assert np.percentile(d, 99.9) <= 1e-3
    assert d.mean() <= 1e-4
    assert (d.max(axis=-1) > 1e-2).mean() <= 1e-3


def test_mode_and_interior_lod_switches_follow_jax():
    """Near/far mode and the interior-LOD hysteresis along a camera path
    that enters the shell, lingers in the release band and leaves."""
    js = jdemo.build_demo_scene("clouds_high")
    ts = tdemo.build_demo_scene("clouds_high", device="cpu")
    for i, z in enumerate([400.0, 200.0, 150.0, 107.0, 112.0, 118.0, 150.0, 230.0]):
        eye = (0.0, 0.0, z)
        jc = jdemo.Camera.create(jdemo.look_at(eye, (0.0, 0.0, 0.0)))
        tc = tdemo.Camera.create(tdemo.look_at(eye, (0.0, 0.0, 0.0), device="cpu"),
                                 device="cpu")
        js.update(0.1 * i, jc)
        ts.update(0.1 * i, tc)
        ja, ta = js.atmospheres[0], ts.atmospheres[0]
        assert ta.mode == ja.mode, z
        assert ta.effective_config().cloud_lod == ja.effective_config().cloud_lod, z
        np.testing.assert_allclose(ta._params.frame_state.numpy(),
                                   np.asarray(ja._params.frame_state), rtol=0, atol=0)


def _fields(obj):
    return {f.name: None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def test_convert_round_trip():
    js = jdemo.build_demo_scene("clouds_high")
    jc = jdemo.demo_camera("avatar")
    js.update(0.5, jc)
    jp = js.atmospheres[0].build_params()
    for jobj, build in ((jp, convert.atmosphere_params_from_numpy),
                        (jc, convert.camera_from_numpy),
                        (js.opaque, convert.opaque_from_numpy)):
        fields = _fields(jobj)
        port = build(fields, device="cpu")
        back = convert.to_numpy(port)
        assert set(back) <= set(fields)
        for name, value in back.items():
            if fields[name] is None:
                assert value is None, name
            else:
                np.testing.assert_array_equal(value, fields[name].astype(np.float32), name)
        again = convert.to_numpy(build(back, device="cpu"))
        for name, value in again.items():
            assert (value is None) == (back[name] is None)
            if value is not None:
                np.testing.assert_array_equal(value, back[name])


def test_convert_variant_config():
    for variant in ("no_clouds", "clouds", "clouds_high"):
        jcfg = jdemo.demo_variant(variant)
        port = convert.variant_config_from_fields(dataclasses.asdict(jcfg))
        assert port == tdemo.demo_variant(variant)
        assert dataclasses.asdict(port) == dataclasses.asdict(jcfg)


def test_convert_rejects_unknown_fields():
    with pytest.raises(KeyError):
        convert.camera_from_numpy({"fov": np.float32(1.0)}, device="cpu")


def test_port_scene_params_match_jax_scene():
    """The port's own demo builder lands on the JAX builder's uniforms."""
    js = jdemo.build_demo_scene("clouds_high")
    ts = tdemo.build_demo_scene("clouds_high", device="cpu")
    jc = jdemo.demo_camera("interior")
    tc = tdemo.demo_camera("interior", device="cpu")
    np.testing.assert_allclose(tc.view_to_world.numpy(), np.asarray(jc.view_to_world),
                               rtol=0, atol=1e-6)
    js.update(0.5, jc)
    ts.update(0.5, tc)
    jp = _fields(js.atmospheres[0].build_params().resolve_frame_state())
    tp = convert.to_numpy(ts.atmospheres[0].build_params().resolve_frame_state())
    for name, value in tp.items():
        if value is not None:
            np.testing.assert_allclose(value, jp[name], rtol=1e-6, atol=1e-7, err_msg=name)
    for name, value in convert.to_numpy(ts.opaque).items():
        if value is None:  # no panorama on either side
            assert _fields(js.opaque)[name] is None, name
            continue
        np.testing.assert_allclose(value, _fields(js.opaque)[name], rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def _scene(variant="clouds_high", pose="avatar"):
    scene = tdemo.build_demo_scene(variant, device="cpu")
    cam = tdemo.demo_camera(pose, device="cpu")
    scene.update(0.5, cam)
    return scene, cam


def test_render_refuses_far_mode_layers():
    """Far-mode layers are no longer refused: such a layer renders on its
    row band, and the banded frame equals the fullscreen one (the layer
    forced fullscreen)."""
    scene, cam = _scene("no_clouds", pose="space")
    assert scene.atmospheres[0].mode == tscene.MODE_FAR
    order, params, configs = scene._sorted_layers(cam)
    bands = scene._layer_bands(order, params, configs, (None,), cam, 128)[4:]
    assert bands[0] is not None and bands[1] is not None
    mk.counters.reset()
    banded = scene.render(cam, 128, 192)
    scene.atmospheres[0].force_fullscreen = True
    scene.update(0.5, cam)
    assert scene.atmospheres[0].mode == tscene.MODE_NEAR
    full = scene.render(cam, 128, 192)
    assert mk.counters.plain_calls == 2
    for k in ("color", "alpha"):
        np.testing.assert_allclose(banded[k].numpy(), full[k].numpy(), atol=2e-6)


def test_render_refuses_multiple_layers():
    """Several layers render (far to near), unless they disagree on the
    engine-global ``reverse_z`` depth convention (``ValueError``, as JAX)."""
    scene, cam = _scene("no_clouds")
    scene.atmospheres.append(tscene.PlanetAtmosphere(
        planet_radius=10.0, atmosphere_height=1.0, position=(300.0, 0.0, 0.0),
        device="cpu"))
    scene.update(0.5, cam)
    assert scene.render(cam, 8, 16)["color"].shape == (8, 16, 3)
    moon = scene.atmospheres[1]
    moon.set_custom_shader(dataclasses.replace(moon.config, reverse_z=False))
    with pytest.raises(ValueError):
        scene.render(cam, 8, 16)


@pytest.mark.parametrize("change", [dict(cloud_shape_noise=None), dict(od_mode="lut"),
                                    dict(cloud_coverage_noise=None)])
def test_render_refuses_unported_configs(change):
    """Clouds without a shape or a coverage field (no procedural spec and
    no texture) are a user error, as in JAX.  The optical-depth LUT renders,
    by the plain route: the kernel's plan refuses it, so
    ``renderer="kernel"`` raises ``ValueError`` (as JAX's ``"pallas"``)."""
    scene, cam = _scene()
    atmo = scene.atmospheres[0]
    atmo.set_custom_shader(dataclasses.replace(atmo.config, **change))
    if "od_mode" in change:
        _, params, configs = scene._sorted_layers(cam)
        assert scene._kernel_plan(params, configs) is None
        assert params[0].optical_depth_lut.shape == (256, 256)
        with pytest.raises(ValueError):
            scene.render(cam, 8, 16, renderer="kernel")
        out = scene.render(cam, 8, 16)
        assert torch.isfinite(out["color"]).all() and torch.isfinite(out["alpha"]).all()
        return
    with pytest.raises(ValueError):
        scene.render(cam, 8, 16)


def test_render_refuses_large_worlds():
    """A camera beyond ``LARGE_WORLD_THRESHOLD`` no longer raises: the scene
    renders camera-relative, rebased on the camera's position, and the frame
    matches the one rendered without the rebase there (at 5e4 float32 still
    resolves the scene) within the cloud tolerance."""
    scene, cam = _scene()
    far = tdemo.Camera.create(tdemo.look_at((0.0, 0.0, 5.0e4), (0.0, 0.0, 0.0), device="cpu"),
                              device="cpu")
    out = scene.render(far, 8, 16)
    np.testing.assert_array_equal(scene._rebase_origin, [0.0, 0.0, 5.0e4])
    scene.large_world = False
    raw = scene.render(far, 8, 16)
    assert scene._rebase_origin is None
    d = np.abs(out["color"].numpy() - raw["color"].numpy())
    assert np.isfinite(d).all() and np.percentile(d, 99.9) <= 1e-3


def test_textures_are_not_ported():
    """The cloud textures are ported (tests/test_torch_texture_scene.py),
    one baked field beside one procedural field too
    (tests/test_torch_texture_envelope.py): a baked shape texture beside
    the procedural coverage renders, through its pyramid.  So is the
    optical-depth LUT texture: the uniform stores it."""
    scene, cam = _scene()
    atmo = scene.atmospheres[0]
    atmo.set_shader_parameter("u_optical_depth_texture", np.ones((4, 4)))
    assert atmo.get_shader_parameter("u_optical_depth_texture").shape == (4, 4)
    atmo.set_shader_parameter("u_cloud_shape_texture", np.zeros((8, 8, 8)))
    assert atmo.get_shader_parameter("u_cloud_shape_texture").shape == (8, 8, 8)
    atmo.set_custom_shader(dataclasses.replace(atmo.config, cloud_shape_noise=None))
    _, params, configs = scene._sorted_layers(cam)
    config, tex = scene._texture_plan(params[0], configs[0])
    assert config.cloud_shape_tex_meta is not None and config.cloud_coverage_tex_meta is None
    assert tex[0] is not None and tex[1] is None
    out = scene.render(cam, 8, 16)
    assert torch.isfinite(out["color"]).all() and torch.isfinite(out["alpha"]).all()


def test_shader_parameter_surface():
    scene, _ = _scene()
    atmo = scene.atmospheres[0]
    with pytest.raises(KeyError):
        atmo.set_shader_parameter("u_nope", 1.0)
    atmo.set_shader_parameter("u_density", 0.25)
    assert float(atmo.get_shader_parameter("u_density")) == 0.25
    modulate = atmo.get_shader_parameter("u_atmosphere_modulate").numpy()
    np.testing.assert_allclose(modulate, [1.0, 0.980392, 0.964706], atol=1e-5)
    atmo.planet_radius = 90.0
    assert atmo.planet_radius == 90.0 and float(atmo.build_params().planet_radius) == 90.0


def test_port_package_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import godot_atmosphere_shader_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 20, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.startswith('godot_atmosphere_shader_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
