"""The texture slice as a whole: the demo scene with baked clouds.

One module fixture bakes the demo's textures once in JAX (the 64³ cellular
shape texture and the 256² coverage cubemap, ~40 s of CPU) and carries them
across as numpy; the port's bake itself is held against JAX's at a reduced
size in ``tests/test_torch_sampling.py`` and runs full size on the card.

* The port's CPU ``Scene.render`` of the ``clouds`` texture scene (avatar,
  t = 0, 64×128) — the megakernel's plain version, pyramid sampling in
  32×128-tile batches — against the committed golden
  ``tests/golden_images/texture_mode_avatar.png``, the interpret-mode TPU
  kernel's frame (``tests/test_texture_mode.py``): ≤ 2/255 per pixel.
* The port's exact-sampling ``render_frame`` against the JAX XLA texture
  path (``renderer="xla"`` with both knot flags) at the interior pose
  (cloud LOD 4), 64×128, cloud tolerance: p99.9 |Δ| ≤ 1e-3, mean |Δ| ≤
  1e-4, at most 0.1 % of pixels above 1e-2.
* Port pyramid against port exact at the interior pose: mean |Δ| < 2e-3
  (the JAX package's own bound, ``tests/test_texture_mode.py``); and a
  far-mode ``clouds_high`` texture layer at the space pose (192×256,
  banded on rows [56, 184): its pyramid batches are the band's own 32×128
  tiles from row 56) against the fullscreen exact-sampling frame, the same
  bound.
* What the texture path refuses, the pyramid cache, and the host side of a
  texture launch (the ``.cu`` structs against their ctypes mirrors are
  checked with the others in ``tests/test_torch_megakernel.py``).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models import demo as jdemo
from godot_atmosphere_shader_tpu.ops.pallas import texsample as jts
from godot_atmosphere_shader_tpu.utils.image_io import read_png, to_uint8
from godot_atmosphere_shader_tpu_torch.models import convert
from godot_atmosphere_shader_tpu_torch.models import demo as tdemo
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from godot_atmosphere_shader_tpu_torch.render.renderer import render_frame

torch.set_num_threads(2)

H, W = 64, 128
GOLDEN = os.path.join(os.path.dirname(__file__), "golden_images", "texture_mode_avatar.png")


@pytest.fixture(scope="module")
def jax_scene():
    """The JAX texture scene, baked once; its textures are carried across."""
    return jdemo.build_demo_scene("clouds", procedural=False)


@pytest.fixture(scope="module")
def textures(jax_scene):
    p = jax_scene.atmospheres[0].build_params()
    return (torch.from_numpy(np.array(p.cloud_shape_texture, np.float32)),
            torch.from_numpy(np.array(p.cloud_coverage_cubemap, np.float32)))


def _port_scene(textures, pose, t=0.0):
    scene = tdemo.build_demo_scene("clouds", procedural=False, device="cpu",
                                   textures=textures)
    cam = tdemo.demo_camera(pose, device="cpu")
    scene.update(t, cam)
    return scene, cam


def _image(out):
    return torch.cat([out["color"], out["alpha"][..., None]], dim=-1).numpy()


def test_texture_scene_render_matches_tpu_golden(textures):
    scene, cam = _port_scene(textures, "avatar")
    mk.counters.reset()
    out = scene.render(cam, H, W)
    assert (mk.counters.plain_calls, mk.counters.megakernel_launches) == (1, 0)
    assert set(out) == {"color", "alpha"}
    img = out["color"].numpy()
    assert np.isfinite(img).all() and img.mean() > 0.01
    golden = read_png(GOLDEN).astype(np.int16)
    diff = np.abs(to_uint8(np.clip(img, 0.0, 1.0)).astype(np.int16) - golden)
    assert diff.max() <= 2, f"{int((diff > 2).sum())} px over, max {int(diff.max())}"


@pytest.fixture(scope="module")
def interior(jax_scene, textures):
    """Interior pose (LOD 4): JAX XLA exact frame, port exact and port
    pyramid frames."""
    jcam = jdemo.demo_camera("interior")
    jax_scene.update(0.0, jcam)
    atmo = jax_scene.atmospheres[0]
    base = atmo.config
    atmo.set_custom_shader(dataclasses.replace(base, cloud_shape_interp=True,
                                               cloud_coverage_interp=True))
    try:
        jout = jax_scene.render(jcam, H, W, renderer="xla")
        ref = np.concatenate([np.asarray(jout["color"]), np.asarray(jout["alpha"])[..., None]], -1)
    finally:
        atmo.set_custom_shader(base)
    scene, cam = _port_scene(textures, "interior")
    _, params, configs = scene._sorted_layers(cam)
    assert configs[0].cloud_lod == 4
    exact_cfg = dataclasses.replace(configs[0], cloud_shape_interp=True,
                                    cloud_coverage_interp=True)
    exact = _image(render_frame(params[0], exact_cfg, cam, scene.opaque, H, W))
    pyramid = _image(scene.render(cam, H, W))
    return ref, exact, pyramid


def test_exact_sampling_matches_jax_xla(interior):
    ref, exact, _ = interior
    assert np.isfinite(exact).all()
    d = np.abs(exact.astype(np.float64) - ref)
    assert np.percentile(d, 99.9) <= 1e-3
    assert d.mean() <= 1e-4
    assert (d.max(axis=-1) > 1e-2).mean() <= 1e-3


def test_pyramid_sampling_near_exact_at_interior(interior):
    _, exact, pyramid = interior
    assert float(np.abs(pyramid[..., :3] - exact[..., :3]).mean()) < 2e-3


def test_far_mode_texture_layer_near_exact(textures):
    scene = tdemo.build_demo_scene("clouds_high", procedural=False, device="cpu",
                                   textures=textures)
    cam = tdemo.demo_camera("space", device="cpu")
    scene.update(0.0, cam)
    order, params, configs = scene._sorted_layers(cam)
    config, tex = scene._texture_plan(params[0], configs[0])
    plan = scene._layer_bands(order, params, (config,), (tex,), cam, 192)
    assert plan[4] == (128,) and plan[5].tolist() == [56]
    mk.counters.reset()
    banded = _image(scene.render(cam, 192, 256))
    assert mk.counters.plain_calls == 1
    exact_cfg = dataclasses.replace(configs[0], cloud_shape_interp=True,
                                    cloud_coverage_interp=True)
    exact = _image(render_frame(params[0], exact_cfg, cam, scene.opaque, 192, 256))
    assert np.isfinite(banded).all() and np.abs(exact[..., 3]).max() > 0.3
    assert float(np.abs(banded[..., :3] - exact[..., :3]).mean()) < 2e-3


@pytest.mark.parametrize("size", [(48, 128), (32, 96)])
def test_partial_tiles_render(textures, size):
    """Frames that are not whole 32×128 tiles: the plain version renders
    the padded grid (the rows and columns past the edge belong to their
    tile's batches, as on the TPU grid) and crops it."""
    scene, cam = _port_scene(textures, "avatar")
    img = _image(scene.render(cam, *size))
    assert img.shape == (*size, 4) and np.isfinite(img).all()
    assert 0.0 <= img[..., 3].min() and img[..., 3].max() <= 1.0


def test_unpackable_texture_raises(textures):
    """A 48³ shape texture the pyramid builder refuses: the layer keeps no
    pyramid metas, which the kernel's envelope refuses (the card raises);
    on the CPU the plain chain samples it exactly."""
    scene, cam = _port_scene(textures, "avatar")
    scene.atmospheres[0].set_shader_parameter("u_cloud_shape_texture",
                                              np.zeros((48, 48, 48), np.float32))
    _, params, configs = scene._sorted_layers(cam)
    cfg, tex = scene._texture_plan(params[0], configs[0])
    assert tex is None and cfg.cloud_shape_tex_meta is None
    with pytest.raises(ValueError):
        mk.check_config(cfg)
    out = scene.render(cam, H, W)
    exact = render_frame(params[0], cfg, cam, scene.opaque, H, W)
    assert torch.equal(out["color"], exact["color"])


def test_pyramids_are_built_once_per_texture(textures):
    scene, cam = _port_scene(textures, "avatar")
    _, params, configs = scene._sorted_layers(cam)
    cfg, tex = scene._texture_plan(params[0], configs[0])
    cfg2, tex2 = scene._texture_plan(params[0], configs[0])
    assert tex2[0] is tex[0] and tex2[1] is tex[1]
    assert cfg.cloud_shape_interp and cfg.cloud_coverage_interp
    assert tex[0].shape == (cfg.cloud_shape_tex_meta.rows, 128)
    assert [lv[0] for lv in cfg.cloud_shape_tex_meta.levels] == [64, 32, 16, 8]
    assert cfg.cloud_coverage_tex_meta.levels[0][:2] == (256, 512)
    mk.check_config(cfg)  # the texture instance takes the demo profile


def test_texture_launch_structs(textures):
    """The host side of a texture launch: the frame struct (no procedural
    noise) and the pyramid struct, levels finest first."""
    scene, cam = _port_scene(textures, "interior")
    _, params, configs = scene._sorted_layers(cam)
    cfg, _ = scene._texture_plan(params[0], configs[0])
    s = mk.frame_constants(params[0], cfg, cam, scene.opaque, H, W)
    assert (s.clouds_enabled, s.cloud_lod, s.coverage_lod, s.shape.octaves) == (1, 4, 2, 0)
    t = mk.tex_constants(cfg)
    assert list(t.shape_size)[:t.shape_levels] == [64, 32, 16, 8]
    assert [lv[1] for lv in cfg.cloud_shape_tex_meta.levels] == list(t.shape_base)[:4]
    assert list(t.cov_width)[:t.cov_levels] == [512, 256, 128, 64, 32]
    assert (t.shape_floor, t.cov_floor) == (2, 3)
    assert (t.window_rows, t.band_rows, t.knot_group, t.shape_knots) == (16, 16, 8, 16)


def test_texture_config_converts_from_jax(jax_scene, textures):
    """What JAX's Scene._pallas_plan builds converts to what the port's
    scene builds, metas included."""
    p = jax_scene.atmospheres[0].build_params()
    _, smeta = jts.build_tex3d_pyramid(np.asarray(p.cloud_shape_texture))
    jcfg = dataclasses.replace(jax_scene.atmospheres[0].config, cloud_shape_tex_meta=smeta,
                               cloud_shape_interp=True)
    port = convert.variant_config_from_fields(dataclasses.asdict(jcfg))
    assert port.cloud_shape_tex_meta == tdemo.build_demo_scene(
        "clouds", procedural=False, device="cpu", textures=textures)._tex_pyramid(
            textures[0], "tex3d")[1]
    assert port.cloud_shape_interp and port.cloud_coverage_tex_meta is None
    assert tdemo.demo_variant("clouds", procedural=False) == convert.variant_config_from_fields(
        dataclasses.asdict(jdemo.demo_variant("clouds", procedural=False)))


@pytest.mark.parametrize("change", [dict(cloud_shape_interp=False),
                                    dict(cloud_coverage_tex_meta=None, cloud_coverage_noise=None),
                                    dict(cloud_lod=3), dict(texture_band_rows=12),
                                    dict(texture_knot_group=0)])
def test_wrapper_rejects_texture_configs_outside_the_kernel(textures, change):
    """The texture instances' envelope (``check_config``, which the wrapper
    applies to CUDA tensors): what the JAX kernel's ``_check_config``
    refuses (a baked field without its knot flag, a baked field without a
    pyramid or a spec, banded rows not a multiple of 8), a LOD group that
    does not divide the tile, no knot group."""
    scene, cam = _port_scene(textures, "avatar")
    _, params, configs = scene._sorted_layers(cam)
    cfg, tex = scene._texture_plan(params[0], configs[0])
    with pytest.raises(ValueError):
        mk.check_config(dataclasses.replace(cfg, **change))


@pytest.mark.parametrize("change,fixed", [
    (dict(cloud_shape_knots=8), False), (dict(cloud_shape_knots=32), False),
    (dict(cloud_lod=1), False), (dict(texture_knot_group=9), True)])
def test_wrapper_takes_texture_configs_of_the_jax_envelope(textures, change, fixed):
    """What the texture instance refused before its envelope was ported
    renders now: other shape knot counts and LOD groups through the general
    instance, any knot group through the fixed one too."""
    scene, cam = _port_scene(textures, "avatar")
    _, params, configs = scene._sorted_layers(cam)
    cfg, tex = scene._texture_plan(params[0], configs[0])
    cfg = dataclasses.replace(cfg, **change)
    mk.check_config(cfg)
    struct = mk.frame_constants(params[0], cfg, cam, scene.opaque, H, W)
    assert mk.texture_mode(cfg)
    assert mk.fixed_texture_instance(struct, mk.tex_constants(cfg)) == fixed
