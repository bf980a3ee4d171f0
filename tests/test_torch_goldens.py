"""The port's CPU ``Scene.render`` against the committed TPU-era goldens of
the exterior and multi-planet frames, and the gas-giant scene against the
JAX package.

Goldens (``tests/golden_images/*.png``, 96×144, built as in
``tests/test_goldens.py:63-115``): every pixel within 2/255 (measured: max
1/255 on all four).  These frames are far mode at their poses, so they go
through the row bands, the opaque-only pass, the layer chain, v1 and
raymarched lighting of the plain path.

Gas giant: the port's ``build_gas_giant_scene``/``gas_giant_camera`` carry
the JAX builder's uniforms and pose, and its frame (192×128, banded at the
limb pose) matches the JAX XLA frame at the cloud-free tolerance (atol 1e-5
with rtol 1e-4) but for a stated budget of limb pixels: at most 0.3 % of
the pixels, all on rays through the shell, none off by more than 5e-4
(measured: 58 of 24,576, max 4.5e-4).  Every such ray is a full-traversal
chord of optical depth up to ~8000 over 64 steps, which amplifies
ulp-level differences (XLA contracts multiply-adds, the port rounds each
operation); the JAX package's own oracle check at this pose reads max
3.7e-4 (ROADMAP, "Oracle parity at gas-giant geometry").
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models import demo as jdemo
from godot_atmosphere_shader_tpu.utils.image_io import read_png, to_uint8
from godot_atmosphere_shader_tpu_torch.models import convert
from godot_atmosphere_shader_tpu_torch.models import demo as tdemo
from godot_atmosphere_shader_tpu_torch.models.scene import MODE_FAR, PlanetAtmosphere
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

torch.set_num_threads(2)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden_images")
MOON = dict(planet_radius=10.0, atmosphere_height=2.0, position=(-188.991, 0.0, 192.584))


def _golden_scene(name):
    if name == "rm_multiplanet_space":
        scene = tdemo.build_demo_scene("clouds_high_rm", device="cpu")
        scene.atmospheres.append(PlanetAtmosphere(sun=scene.atmospheres[0].sun,
                                                  custom_shader="v1_no_clouds", device="cpu",
                                                  **MOON))
        return scene, "space", 2
    variant, pose = {"v1_exterior": ("v1_no_clouds", "exterior"),
                     "v2_exterior": ("no_clouds", "exterior"),
                     "clouds_space": ("clouds", "space")}[name]
    return tdemo.build_demo_scene(variant, device="cpu"), pose, 1


@pytest.mark.parametrize("name", ["v1_exterior", "v2_exterior", "clouds_space",
                                  "rm_multiplanet_space"])
def test_render_matches_tpu_golden(name):
    scene, pose, layers = _golden_scene(name)
    cam = tdemo.demo_camera(pose, device="cpu")
    scene.update(0.0, cam)
    assert all(a.mode == MODE_FAR for a in scene.atmospheres)
    mk.counters.reset()
    img = scene.render(cam, 96, 144)["color"].numpy()
    assert mk.counters.plain_calls == 1 and len(scene.atmospheres) == layers
    golden = read_png(os.path.join(GOLDEN_DIR, f"{name}.png")).astype(np.int16)
    diff = np.abs(to_uint8(np.clip(img, 0.0, 1.0)).astype(np.int16) - golden)
    assert diff.max() <= 2, f"{int((diff > 2).sum())} values over, max {int(diff.max())}"


def _fields(obj):
    return {f.name: None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def gas_giant():
    jscene = jdemo.build_gas_giant_scene()
    jcam = jdemo.gas_giant_camera("limb")
    jscene.update(0.5, jcam)
    tscene = tdemo.build_gas_giant_scene(device="cpu")
    tcam = tdemo.gas_giant_camera("limb", device="cpu")
    tscene.update(0.5, tcam)
    return jscene, jcam, tscene, tcam


def test_gas_giant_scene_converts_from_jax(gas_giant):
    jscene, jcam, tscene, tcam = gas_giant
    ja, ta = jscene.atmospheres[0], tscene.atmospheres[0]
    assert ta.config == convert.variant_config_from_fields(dataclasses.asdict(ja.config))
    assert ta.mode == ja.mode == MODE_FAR and ta.extra_cull_margin == ja.extra_cull_margin
    jp = _fields(ja.build_params().resolve_frame_state())
    for name, value in convert.to_numpy(ta.build_params().resolve_frame_state()).items():
        if value is not None:
            np.testing.assert_allclose(value, jp[name], rtol=1e-6, atol=1e-7, err_msg=name)
    for name, value in convert.to_numpy(tscene.opaque).items():
        if value is None:  # no panorama on either side
            assert _fields(jscene.opaque)[name] is None, name
            continue
        np.testing.assert_allclose(value, _fields(jscene.opaque)[name], rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    port_cam = convert.camera_from_numpy(_fields(jcam), device="cpu")
    for name in ("view_to_world", "fov_y_rad", "near", "far"):
        np.testing.assert_allclose(getattr(tcam, name).numpy(),
                                   getattr(port_cam, name).numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    for pose in ("exterior", "interior", "space"):
        np.testing.assert_allclose(tdemo.gas_giant_camera(pose, device="cpu").view_to_world,
                                   np.asarray(jdemo.gas_giant_camera(pose).view_to_world),
                                   rtol=0, atol=1e-4)
    with pytest.raises(ValueError):
        tdemo.gas_giant_camera("nowhere", device="cpu")


def test_gas_giant_frame_matches_jax_xla(gas_giant):
    jscene, jcam, tscene, tcam = gas_giant
    h, w = 192, 128
    jout = jscene.render(jcam, h, w)
    ref = np.concatenate([np.asarray(jout["color"]), np.asarray(jout["alpha"])[..., None]], -1)
    order, params, configs = tscene._sorted_layers(tcam)
    assert tscene._layer_bands(order, params, configs, (None,), tcam, h)[4] is not None
    out = tscene.render(tcam, h, w)
    got = torch.cat([out["color"], out["alpha"][..., None]], -1).numpy()
    assert np.isfinite(got).all() and got[..., 3].max() > 0.5
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert bad.mean() <= 3e-3, int(bad.sum())
    assert np.abs(got - ref).max() <= 5e-4
    assert (ref[..., 3][bad] > 0.0).all()  # rays through the shell only


def test_gas_giant_xla_reference_is_the_jax_frame(gas_giant):
    """``tests/golden_gas_giant_xla.npz`` holds this scene's JAX XLA frame
    (192×128 at the limb pose), which ``chip_smoke.py`` phase 3i carries to
    the card, where JAX does not run: the JAX package renders it again here
    within the golden's budget (on the CPU it was written on, bit for bit).
    To write it anew: ``np.savez_compressed(path, frame=ref)`` with ``ref``
    as this test builds it."""
    jscene, jcam, _, _ = gas_giant
    jout = jscene.render(jcam, 192, 128)
    ref = np.concatenate([np.asarray(jout["color"]), np.asarray(jout["alpha"])[..., None]], -1)
    saved = np.load(os.path.join(os.path.dirname(__file__), "golden_gas_giant_xla.npz"))["frame"]
    assert saved.shape == ref.shape == (192, 128, 4) and saved.dtype == np.float32
    bad = ~np.isclose(saved, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert bad.mean() <= 3e-3 and np.abs(saved - ref).max() <= 5e-4
