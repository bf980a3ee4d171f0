"""The panorama sky: the port against the JAX package on the same inputs.

* ``build_equirect_pyramid`` and ``Scene._pano_plan``'s pyramid width equal
  JAX's exactly.
* The plain sky sampler (``sample_sky_batched``: three channel pyramids,
  one choice per 32×128 tile, a 32-row window) against JAX
  ``sample_latlong(window_rows=32)`` run through an interpret-mode
  ``pl.pallas_call`` harness (as ``tests/test_torch_texsample.py`` runs K2),
  atol 2e-6, with the chosen mode and level asserted: a windowed tile, a
  tile on the azimuth seam (floor mode) and polar tiles; the plain version
  of the kernel's per-tile choice pre-pass gives each tile that choice.
* ``sample_equirect_bilinear`` (the exact sampler) against JAX at atol 1e-5.
* Cloud-free frames with a panorama against JAX ``render_scene_pallas(...,
  pano_data, pano_meta, interpret=True)`` at ``tests/test_pallas.py:38``'s
  bound (atol 1e-5, rtol 1e-4): a fused ``no_clouds`` layer (64×128, the
  partial-tile 72×200, and a camera facing the seam), the opaque-only pass
  under banded layers, and a 3-frame TAA flight against the JAX interpret
  flight; the exact path against JAX ``renderer="xla"``.
* The everything-on frame (``tools/tpu_checks.py:318-342``: texture clouds,
  the check's 32×64 panorama, a far-mode moon), its textures carried across
  from this file's one JAX bake: at ``avatar`` the port's CPU
  ``Scene.render`` at 256×384 meets the TPU signature
  ``tests/golden_allon_sig.npz`` and the JAX interpret frame of the same
  plan (cloud tolerance); at ``space`` (both layers banded: the opaque-only
  pass draws the sky) it meets the JAX interpret frame at 128×192.
* Refusals, the launch plan's sky plumbing and the convert round trip.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from godot_atmosphere_shader_tpu.models import demo as jdemo
from godot_atmosphere_shader_tpu.models.scene import PlanetAtmosphere as JAtmo
from godot_atmosphere_shader_tpu.ops import sampling as jsampling
from godot_atmosphere_shader_tpu.ops.pallas import texsample as jts
from godot_atmosphere_shader_tpu.ops.pallas.megakernel import render_scene_pallas
from godot_atmosphere_shader_tpu.utils.camera import Camera as JCamera
from godot_atmosphere_shader_tpu.utils.vecmath import Vec3 as JVec3
from godot_atmosphere_shader_tpu_torch.models import convert
from godot_atmosphere_shader_tpu_torch.models import demo as tdemo
from godot_atmosphere_shader_tpu_torch.models.scene import PlanetAtmosphere as TAtmo
from godot_atmosphere_shader_tpu_torch.ops import sampling as tsampling
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from godot_atmosphere_shader_tpu_torch.ops.kernels import texsample as tts
from godot_atmosphere_shader_tpu_torch.render.renderer import render_scene
from godot_atmosphere_shader_tpu_torch.utils.camera import Camera, look_at, world_ray_dirs
from godot_atmosphere_shader_tpu_torch.utils.flight import FlyCamera
from godot_atmosphere_shader_tpu_torch.utils.vecmath import Vec3

torch.set_num_threads(2)

H, W = 64, 128
MOON = dict(planet_radius=10.0, atmosphere_height=2.0, position=(-188.991, 0.0, 192.584))
SIG = "tests/golden_allon_sig.npz"
SIG_BLOCK = (8, 128)
TIMES = [0.5, 0.5 + 1 / 60, 0.5 + 2 / 60]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _image(out):
    return np.concatenate([np.asarray(out["color"]), np.asarray(out["alpha"])[..., None]], -1)


def _cloud_ok(got, ref):
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    return (np.percentile(d, 99.9) <= 1e-3 and d.mean() <= 1e-4
            and (d.max(axis=-1) > 1e-2).mean() <= 1e-3)


def _panorama(seed, h=256, w=512):
    """A seeded smooth RGB panorama in [0, 0.5): a coarse random grid
    upsampled bilinearly."""
    coarse = np.random.default_rng(seed).random((3, h // 16, w // 16)).astype(np.float32)
    up = torch.nn.functional.interpolate(_t(coarse)[None], size=(h, w), mode="bilinear",
                                         align_corners=False)[0]
    return np.ascontiguousarray(0.5 * up.permute(1, 2, 0).numpy())


def _allon_panorama():
    """The everything-on check's own panorama (``tools/tpu_checks.py:331-334``)."""
    return np.stack([np.tile((np.arange(64) + 0.5) / 64, (32, 1)),
                     np.tile(((np.arange(32) + 0.5) / 32)[:, None], (1, 64)),
                     np.full((32, 64), 0.25)], -1).astype(np.float32)


# -- pyramids and the pyramid width ----------------------------------------------


@pytest.mark.parametrize("shape,width", [((32, 64, 3), 64), ((48, 100, 3), 128),
                                         ((64, 128, 3), 256)])
def test_equirect_pyramid_equals_jax(shape, width):
    img = np.random.default_rng(width).random(shape).astype(np.float32)
    jdatas, jmeta = jts.build_equirect_pyramid(img, width=width)
    datas, meta = tts.build_equirect_pyramid(img, width=width)
    assert dataclasses.asdict(meta) == dataclasses.asdict(jmeta)
    for got, ref in zip(datas, jdatas):
        np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("src_width", [40, 64, 100, 2048, 3000])
def test_pano_plan_width_equals_jax(src_width):
    img = np.random.default_rng(src_width).random((8, src_width, 3)).astype(np.float32)
    jscene = jdemo.build_demo_scene("no_clouds")
    jscene.opaque = dataclasses.replace(jscene.opaque, panorama=img)
    scene = tdemo.build_demo_scene("no_clouds", device="cpu")
    scene.opaque = dataclasses.replace(scene.opaque, panorama=_t(img))
    (datas, meta), (jdatas, jmeta) = scene._pano_plan(), jscene._pano_plan()
    assert dataclasses.asdict(meta) == dataclasses.asdict(jmeta)
    np.testing.assert_array_equal(datas[2].numpy(), np.asarray(jdatas[2]))
    assert scene._pano_plan()[0][0] is datas[0]  # built once per panorama object


# -- the plain sky sampler against JAX sample_latlong(window_rows=32) -------------


def _jax_sky(datas, meta, d):
    def kern(r_ref, g_ref, b_ref, dx_ref, dy_ref, dz_ref, o_r, o_g, o_b):
        dirs = JVec3(dx_ref[:], dy_ref[:], dz_ref[:])
        for tab, out in ((r_ref, o_r), (g_ref, o_g), (b_ref, o_b)):
            out[:] = jts.sample_latlong(tab, meta, dirs, window_rows=32)

    shape = jax.ShapeDtypeStruct(d[0].shape, jnp.float32)
    return [np.asarray(o) for o in pl.pallas_call(kern, out_shape=[shape] * 3, interpret=True)(
        *(jnp.asarray(t) for t in datas), *(jnp.asarray(c) for c in d))]


def _directions(rng, theta0, phi0, span, shape=(32, 128)):
    theta = theta0 + span[0] * rng.random(shape)
    phi = phi0 + span[1] * rng.random(shape)
    return [c.astype(np.float32) for c in
            (np.cos(phi) * np.cos(theta), np.sin(phi), np.cos(phi) * np.sin(theta))]


@pytest.fixture(scope="module")
def sky_pyramid():
    jdatas, jmeta = jts.build_equirect_pyramid(_panorama(3), width=512)
    return [np.asarray(d) for d in jdatas], jmeta


# (name, (theta0, phi0), (theta span, phi span), expected (mode, level))
SKY_CASES = [
    ("windowed", (0.3, 0.2), (0.05, 0.05), (tts.WINDOWED, 0)),
    ("windowed_coarse", (-1.2, -0.4), (0.6, 0.4), (tts.WINDOWED, 2)),
    ("floor_on_seam", (np.pi - 0.05, -0.1), (0.1, 0.1), (tts.FLOOR, 3)),
    ("polar", (0.3, 1.45), (0.02, 0.1), (tts.WINDOWED, 1)),
    ("polar_cap", (-np.pi, 1.5), (2 * np.pi, 0.07), (tts.FLOOR, 3)),
]


@pytest.mark.parametrize("case", SKY_CASES, ids=[c[0] for c in SKY_CASES])
def test_plain_sky_sampler_matches_jax_interpret(sky_pyramid, case):
    name, (theta0, phi0), span, (mode, level) = case
    jdatas, jmeta = sky_pyramid
    d = _directions(np.random.default_rng(len(name)), theta0, phi0, span)
    refs = _jax_sky(jdatas, jmeta, d)
    meta = tts.TexMeta(**dataclasses.asdict(jmeta))
    tables = [_t(x) for x in jdatas]
    dirs = Vec3(*map(_t, d))
    tts.counters.reset()
    got = tts.sample_sky_batched(tables, meta, dirs, 32)
    assert tts.counters.plain_sky_calls == 1
    _, got_mode, got_level = tts.sample_latlong(tables[0], meta, dirs, window_rows=32,
                                                return_choice=True)
    assert (got_mode, got_level) == (mode, level)
    for g, r in zip(got, refs):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=2e-6)


def test_plain_sky_sampler_is_per_tile(sky_pyramid):
    """Direction planes of 2×2 tiles: each 32×128 tile is sampled as one
    JAX call on that tile alone would sample it."""
    jdatas, jmeta = sky_pyramid
    rng = np.random.default_rng(12)
    tiles = [[_directions(rng, -2.0 + 1.3 * i + 0.7 * j, -0.5 + 0.4 * i, (0.05 + 0.5 * j, 0.1))
              for j in range(2)] for i in range(2)]
    tiles[1][1] = _directions(rng, np.pi - 0.05, 0.2, (0.1, 0.1))  # on the seam
    planes = [np.block([[tiles[i][j][a] for j in range(2)] for i in range(2)]) for a in range(3)]
    got = tts.sample_sky_batched([_t(x) for x in jdatas], tts.TexMeta(**dataclasses.asdict(jmeta)),
                                 Vec3(*map(_t, planes)), 32)
    modes = set()
    for i in range(2):
        for j in range(2):
            refs = _jax_sky(jdatas, jmeta, tiles[i][j])
            for g, r in zip(got, refs):
                np.testing.assert_allclose(g[32 * i:32 * i + 32, 128 * j:128 * j + 128].numpy(),
                                           r, rtol=0, atol=2e-6)
            modes.add(tts.sample_latlong(_t(jdatas[0]), tts.TexMeta(**dataclasses.asdict(jmeta)),
                                         Vec3(*map(_t, tiles[i][j])), window_rows=32,
                                         return_choice=True)[1:])
    assert {m for m, _ in modes} == {tts.WINDOWED, tts.FLOOR}
    mode, level = tts.sky_tile_choices(tts.TexMeta(**dataclasses.asdict(jmeta)),
                                       Vec3(*map(_t, planes)), 32)
    assert set(zip(mode.tolist(), level.tolist())) == modes


@pytest.mark.parametrize("pose,h,w", [("avatar", 64, 128), ("space", 72, 200)])
def test_sky_choices_plain_is_each_tiles_choice(sky_pyramid, pose, h, w):
    """The plain version of the sky's per-tile choice pre-pass: each tile of
    the padded grid gets the choice of the plain sampler (held to JAX above)
    on that tile's rays alone, tiles row-major."""
    _, jmeta = sky_pyramid
    meta = tts.TexMeta(**dataclasses.asdict(jmeta))
    cam = tdemo.demo_camera(pose, device="cpu")
    got = mk.sky_choices_plain(cam, h, w, meta)
    ty, tx = -(-h // 32), -(-w // 128)
    d = world_ray_dirs(cam, h, w, rows=32 * ty, cols=128 * tx)
    want = [tts.sample_latlong(torch.zeros((meta.rows, 128)), meta,
                               Vec3(*(c[32 * i:32 * i + 32, 128 * j:128 * j + 128] for c in d)),
                               window_rows=32, return_choice=True)[1:]
            for i in range(ty) for j in range(tx)]
    assert got.dtype == torch.int32 and got.tolist() == [list(c) for c in want]


def test_exact_equirect_sampler_matches_jax():
    img = _panorama(4, 64, 128)
    rng = np.random.default_rng(7)
    d = rng.normal(size=(3, 64, 96)).astype(np.float32)
    d[:, :8] = np.array([-1.0, 0.01, 0.0], np.float32)[:, None, None] + 1e-3 * d[:, :8]  # seam
    d[:, 8:16] = np.array([0.01, 1.0, 0.02], np.float32)[:, None, None] + 1e-2 * d[:, 8:16]
    ref = jsampling.sample_equirect_bilinear(jnp.asarray(img), JVec3(*map(jnp.asarray, d)))
    got = tsampling.sample_equirect_bilinear(_t(img), Vec3(*map(_t, d)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5)


# -- cloud-free frames against JAX render_scene_pallas(interpret=True) ------------


def _scenes(pano, moon=False, variant="no_clouds"):
    jscene = jdemo.build_demo_scene(variant)
    jscene.opaque = dataclasses.replace(jscene.opaque, panorama=pano)
    scene = tdemo.build_demo_scene(variant, device="cpu")
    scene.opaque = dataclasses.replace(scene.opaque, panorama=_t(pano))
    if moon:
        jscene.atmospheres.append(JAtmo(sun=jscene.atmospheres[0].sun,
                                        custom_shader="no_clouds", **MOON))
        scene.atmospheres.append(TAtmo(sun=scene.atmospheres[0].sun, custom_shader="no_clouds",
                                       device="cpu", **MOON))
    return jscene, scene


def _cameras(pose):
    """The same camera in both packages: a demo pose, or ``"seam"``: the
    avatar's position facing −X, where the panorama's azimuth seam is."""
    if pose == "seam":
        vtw = look_at((0.0, 0.0, 156.425), (-100.0, 10.0, 156.425), device="cpu")
    else:
        vtw = tdemo.demo_camera(pose, device="cpu").view_to_world
    return (JCamera.create(jnp.asarray(vtw.numpy()), fov_y_deg=70.0, near=0.1, far=800.0),
            Camera.create(vtw, fov_y_deg=70.0, near=0.1, far=800.0, device="cpu"))


def _jax_pallas(jscene, jcam, h, w, bands=None, band_rows=None):
    _, params, configs = jscene._sorted_layers(jcam)
    pdata, pmeta = jscene._pano_plan()
    return _image(render_scene_pallas(params, configs, jcam, jscene.opaque, h, w, interpret=True,
                                      bands=bands, band_rows=band_rows, pano_data=pdata,
                                      pano_meta=pmeta))


@pytest.mark.parametrize("pose,h,w", [("avatar", 64, 128), ("avatar", 72, 200),
                                      ("seam", 64, 128)])
def test_fused_layer_with_panorama_matches_jax(pose, h, w):
    jscene, scene = _scenes(_panorama(5))
    jcam, cam = _cameras(pose)
    jscene.update(0.5, jcam)
    scene.update(0.5, cam)
    order, params, configs = scene._sorted_layers(cam)
    assert scene._layer_bands(order, params, configs, (None,), cam, h)[4] is None  # fused
    mk.counters.reset()
    tts.counters.reset()
    got = _image({k: v.numpy() for k, v in scene.render(cam, h, w).items()})
    assert (mk.counters.plain_calls, mk.counters.megakernel_launches) == (1, 0)
    assert tts.counters.plain_sky_calls == 1
    ref = _jax_pallas(jscene, jcam, h, w)
    assert np.isfinite(got).all() and got.shape == (h, w, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_opaque_only_pass_with_panorama_matches_jax():
    """Both layers banded (the planet over the whole frame, the moon on
    rows [32, 64)): the opaque-only pass draws the sky."""
    jscene, scene = _scenes(_panorama(6), moon=True)
    jcam, cam = _cameras("space")
    jscene.update(0.5, jcam)
    scene.update(0.5, cam)
    bands, rows = (64, 32), [0, 32]
    _, params, configs = scene._sorted_layers(cam)
    pdata, pmeta = scene._pano_plan()
    got = _image({k: v.numpy() for k, v in render_scene(
        params, configs, cam, scene.opaque, H, W, bands=bands, band_rows=rows,
        pano_data=pdata, pano_meta=pmeta).items()})
    ref = _jax_pallas(jscene, jcam, H, W, bands, np.asarray(rows, np.int32))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    plan = mk.scene_launches(params, configs, cam, scene.opaque, H, W, bands=bands,
                             band_rows=rows, pano_data=pdata, pano_meta=pmeta)
    assert [(k, s.with_sky, a["sky"] is not None) for k, s, a in plan] == [
        ("opaque", 1, True), ("band", 0, False), ("band", 0, False)]


def test_exact_path_matches_jax_xla():
    """Without pyramids the plain frame samples the panorama exactly, the
    twin of the JAX ``renderer="xla"`` frame."""
    jscene, scene = _scenes(_panorama(8, 64, 128))
    jcam, cam = _cameras("avatar")
    jscene.update(0.5, jcam)
    scene.update(0.5, cam)
    ref = _image(jscene.render(jcam, H, W, renderer="xla"))
    _, params, configs = scene._sorted_layers(cam)
    tts.counters.reset()
    got = _image({k: v.numpy() for k, v in render_scene(params, configs, cam, scene.opaque,
                                                        H, W).items()})
    assert tts.counters.plain_sky_calls == 0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_taa_flight_with_panorama_matches_jax_interpret():
    """From the avatar pose, turning and climbing a little each frame: no
    pixel reprojects exactly onto the frame's edge (a pure translation puts
    the far sky of the edge rows on the TAA window's threshold, where one
    rounding flips validity)."""
    jscene, scene = _scenes(_panorama(9))
    fly = FlyCamera(position=(0.0, 0.0, 156.425), speed=10.0)
    stack = []
    for _ in TIMES:
        stack.append(fly.view_to_world())
        fly.look(0.004, 0.003).move((0.0, 0.0, -1.0), dt=1 / 60)
    stack = np.stack(stack).astype(np.float32)
    jcam, cam = _cameras("avatar")
    ref = jscene.render_flight(jcam, TIMES, H, W, cam_transforms=stack, interpret=True,
                               taa_blend=0.2)
    mk.counters.reset()
    out = scene.render_flight(cam, TIMES, H, W, cam_transforms=stack, taa_blend=0.2)
    assert mk.counters.plain_calls == len(TIMES) and mk.counters.megakernel_launches == 0
    np.testing.assert_allclose(_image({k: v.numpy() for k, v in out.items()}),
                               _image(ref), rtol=1e-4, atol=1e-5)


# -- the everything-on frame ------------------------------------------------------


@pytest.fixture(scope="module")
def allon():
    """The JAX everything-on scene (its one texture bake) and its textures."""
    jscene = jdemo.build_demo_scene("clouds", procedural=False)
    jscene.opaque = dataclasses.replace(jscene.opaque, panorama=_allon_panorama())
    jscene.atmospheres.append(JAtmo(sun=jscene.atmospheres[0].sun, custom_shader="no_clouds",
                                    **MOON))
    p = jscene.atmospheres[0].build_params()
    return jscene, (_t(np.array(p.cloud_shape_texture, np.float32)),
                    _t(np.array(p.cloud_coverage_cubemap, np.float32)))


def _port_allon(textures, pose):
    scene = tdemo.build_demo_scene("clouds", procedural=False, device="cpu", textures=textures)
    scene.opaque = dataclasses.replace(scene.opaque, panorama=_t(_allon_panorama()))
    scene.atmospheres.append(TAtmo(sun=scene.atmospheres[0].sun, custom_shader="no_clouds",
                                   device="cpu", **MOON))
    cam = tdemo.demo_camera(pose, device="cpu")
    scene.update(0.25, cam)
    return scene, cam


def _jax_allon(jscene, pose, h, w):
    """JAX's everything-on frame through ``render_scene_pallas`` in interpret
    mode, with the plan ``Scene.render`` builds on a TPU: texture pyramids,
    the band plan and the panorama pyramids."""
    jcam = jdemo.demo_camera(pose)
    jscene.update(0.25, jcam)
    order, params, configs = jscene._sorted_layers(jcam)
    aug, tex = [], []
    for p, c in zip(params, configs):
        if not c.clouds_enabled:
            aug.append(c)
            tex.append(None)
            continue
        shape = jscene._tex_pyramid(p.cloud_shape_texture, "tex3d")
        cov = jscene._tex_pyramid(p.cloud_coverage_cubemap, "latlong")
        aug.append(dataclasses.replace(c, cloud_shape_tex_meta=shape[1], cloud_shape_interp=True,
                                       cloud_coverage_tex_meta=cov[1],
                                       cloud_coverage_interp=True))
        tex.append((shape[0], cov[0]))
    _, params, aug, tex, bands, rows = jscene._layer_bands(order, params, tuple(aug),
                                                           tuple(tex), jcam, h)
    pdata, pmeta = jscene._pano_plan()
    return bands, _image(render_scene_pallas(params, aug, jcam, jscene.opaque, h, w,
                                             interpret=True, tex_data=tex, bands=bands,
                                             band_rows=rows, pano_data=pdata, pano_meta=pmeta))


def _signature(img):
    bh, bw = SIG_BLOCK
    h, w, c = img.shape
    blocks = img.reshape(h // bh, bh, w // bw, bw, c)
    return (blocks.mean(axis=(1, 3)).astype(np.float16),
            blocks.max(axis=(1, 3)).astype(np.float16))


def test_everything_on_avatar_meets_tpu_signature_and_jax(allon):
    jscene, textures = allon
    scene, cam = _port_allon(textures, "avatar")
    order, params, configs = scene._sorted_layers(cam)
    plans = [scene._texture_plan(p, c) for p, c in zip(params, configs)]
    plan = scene._layer_bands(order, params, tuple(c for c, _ in plans),
                              tuple(t for _, t in plans), cam, 256)
    assert len(plan[2]) == 1 and plan[4] is None  # the moon dropped, one fused texture layer
    mk.counters.reset()
    tts.counters.reset()
    got = _image({k: v.numpy() for k, v in scene.render(cam, 256, 384).items()})
    assert (mk.counters.plain_calls, tts.counters.plain_sky_calls) == (1, 1)
    ref = np.load(SIG)
    mean_sig, max_sig = _signature(got[..., :3])
    dmean = np.abs(mean_sig.astype(np.float32) - ref["mean"].astype(np.float32)).max()
    dmax = np.abs(max_sig.astype(np.float32) - ref["max"].astype(np.float32)).max()
    assert dmean <= 3e-3 and dmax <= 3e-2, (dmean, dmax)
    bands, jgot = _jax_allon(jscene, "avatar", 256, 384)
    assert bands is None
    assert np.isfinite(got).all() and _cloud_ok(got, jgot)


def test_everything_on_space_matches_jax(allon):
    """At 128×192 both layers are banded (rows 32+64 and 64+64)."""
    jscene, textures = allon
    scene, cam = _port_allon(textures, "space")
    bands, ref = _jax_allon(jscene, "space", 128, 192)
    assert bands is not None and all(b is not None for b in bands)  # opaque-only pass
    mk.counters.reset()
    got = _image({k: v.numpy() for k, v in scene.render(cam, 128, 192).items()})
    assert mk.counters.plain_calls == 1
    assert np.isfinite(got).all() and got[..., 3].max() > 0.1 and _cloud_ok(got, ref)


# -- refusals, the launch plan, convert ---------------------------------------------


@pytest.mark.parametrize("bad", [(32, 64), (16, 64, 4)])
def test_unpackable_panorama_raises(bad):
    scene = tdemo.build_demo_scene("no_clouds", device="cpu")
    scene.opaque = dataclasses.replace(scene.opaque, panorama=torch.zeros(bad))
    cam = tdemo.demo_camera("avatar", device="cpu")
    scene.update(0.0, cam)
    with pytest.raises(ValueError):
        scene.render(cam, H, W)


def test_sky_refusals():
    scene = tdemo.build_demo_scene("no_clouds", device="cpu")
    scene.opaque = dataclasses.replace(scene.opaque, panorama=_t(_panorama(10, 32, 64)))
    cam = tdemo.demo_camera("avatar", device="cpu")
    scene.update(0.0, cam)
    _, params, configs = scene._sorted_layers(cam)
    pdata, pmeta = scene._pano_plan()
    with pytest.raises(ValueError):  # a panorama without its pyramids
        mk.render_scene_megakernel(params, configs, cam, scene.opaque, H, W)
    with pytest.raises(ValueError):  # sky tables on another device
        mk.render_scene_megakernel(params, configs, cam, scene.opaque, H, W,
                                   pano_data=tuple(t.to("meta") for t in pdata), pano_meta=pmeta)
    with pytest.raises(ValueError):  # two channels
        mk.render_scene_megakernel(params, configs, cam, scene.opaque, H, W,
                                   pano_data=pdata[:2], pano_meta=pmeta)
    struct = mk.frame_constants(params[0], configs[0], cam, scene.opaque, H, W)
    struct.with_sky = 1
    with pytest.raises(ValueError):  # a sky launch without its pyramids
        mk.launch(struct, torch.empty((H, W, 3)), torch.empty((H, W)))


def test_fused_launch_plan_and_sky_struct():
    scene = tdemo.build_demo_scene("clouds_high", device="cpu")
    scene.opaque = dataclasses.replace(scene.opaque, panorama=_t(_panorama(11, 1024, 2048)))
    cam = tdemo.demo_camera("avatar", device="cpu")
    scene.update(0.0, cam)
    _, params, configs = scene._sorted_layers(cam)
    pdata, pmeta = scene._pano_plan()
    assert [lv[:2] for lv in pmeta.levels] == [(1024, 2048), (512, 1024), (256, 512),
                                               (128, 256), (64, 128), (32, 64), (16, 32)]
    (kind, struct, args), = mk.scene_launches(params, configs, cam, scene.opaque, H, W,
                                              pano_data=pdata, pano_meta=pmeta)
    assert (kind, struct.with_sky, struct.with_opaque) == ("layer", 1, 1)
    t = args["sky"][0]
    assert args["sky"][1:] == pdata and args["tex"] is None
    assert list(t.cov_width)[:t.cov_levels] == [lv[1] for lv in pmeta.levels]
    assert list(t.cov_base)[:t.cov_levels] == [lv[2] for lv in pmeta.levels]
    assert (t.window_rows, t.cov_floor) == (32, pmeta.floor_level(32)) == (32, 5)


def test_panorama_converts_from_jax():
    img = _panorama(12, 32, 64)
    jscene = jdemo.build_demo_scene("no_clouds")
    jopaque = dataclasses.replace(jscene.opaque, panorama=jnp.asarray(img))
    fields = {f.name: None if getattr(jopaque, f.name) is None
              else np.asarray(getattr(jopaque, f.name)) for f in dataclasses.fields(jopaque)}
    port = convert.opaque_from_numpy(fields, device="cpu")
    np.testing.assert_array_equal(port.panorama.numpy(), img)
    assert set(convert.to_numpy(port)) == set(fields)
