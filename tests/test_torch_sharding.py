"""Row-sharded rendering: the port's ``parallel/sharding.py`` against the
JAX package's on the same seeded inputs, on the CPU.

* The host functions that size the TAA halo (``reprojection_row_bound``,
  ``derive_taa_halo``, ``_scene_min_depth``) equal JAX's exactly (float64)
  on the cameras of ``tests/test_sharding_taa.py`` and a seeded set.
* The refusals (height not divisible by the mesh, a shard boundary inside a
  cloud LOD group, rows per shard % 32 for the TAA flight, a halo that is
  not a positive multiple of 8 within the rows per shard) raise
  ``ValueError`` in both packages.
* The plain band chain (the megakernel's band entry on CPU tensors)
  against JAX ``render_scene_band_pallas(interpret=True)`` band by band:
  procedural ``clouds_high`` under a seeded panorama with a far moon at
  64×128 on 2 shards at the cloud tolerance (p99.9 |Δ| ≤ 1e-3, mean ≤ 1e-4,
  ≤ 0.1 % of pixels above 1e-2), and without clouds at atol 1e-5 / rtol
  1e-4 (``tests/test_pallas.py``'s bound); the assembled bands equal the
  port's whole frame.
* ``render_frame_sharded`` (the plain chain per shard) against JAX's XLA
  ``render_frame_sharded`` on a 4-device mesh.
* The sharded TAA flight (``Scene.render_flight(mesh=make_mesh(4))``, the
  local mesh) against JAX's sharded flight in interpret mode on the drift
  of ``tests/test_sharding_taa.py``: max |Δ| < 1e-4 (JAX's envelope between
  its sharded and single-device flights) with at most 0.5 % of pixels past
  atol 1e-5 + rtol 1e-4 (the bound between the two packages); against the
  port's single-device flight, JAX's envelope itself (max |Δ| < 1e-4, at
  most 0.5 % of pixels above 1e-6); the two ``TaaHaloWarning`` cases.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models import demo as jdemo
from godot_atmosphere_shader_tpu.models.scene import PlanetAtmosphere as JAtmo
from godot_atmosphere_shader_tpu.ops.pallas.megakernel import render_scene_band_pallas
from godot_atmosphere_shader_tpu.parallel import sharding as jsh
from godot_atmosphere_shader_tpu_torch.models import demo as tdemo
from godot_atmosphere_shader_tpu_torch.models.scene import PlanetAtmosphere as TAtmo
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from godot_atmosphere_shader_tpu_torch.ops.kernels import taa
from godot_atmosphere_shader_tpu_torch.parallel import sharding as tsh
from godot_atmosphere_shader_tpu_torch.render.renderer import render_scene

torch.set_num_threads(2)

H, W = 128, 128
TIMES = [0.0, 0.016, 0.032]
MOON = dict(planet_radius=10.0, atmosphere_height=2.0, position=(-188.991, 0.0, 192.584))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _image(out):
    return np.concatenate([np.asarray(out["color"]), np.asarray(out["alpha"])[..., None]], -1)


def _cloud_ok(got, ref):
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    return (np.percentile(d, 99.9) <= 1e-3 and d.mean() <= 1e-4
            and (d.max(axis=-1) > 1e-2).mean() <= 1e-3)


def _base():
    return np.asarray(tdemo.demo_camera("space", device="cpu").view_to_world, np.float64)


def _pitched(base, theta):
    """``tests/test_sharding_taa.py``'s pitch about the camera's right axis."""
    c, s = np.cos(theta), np.sin(theta)
    rx = np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], np.float64)
    return base @ rx


def _drift(frames=3):
    """``tests/test_sharding_taa.py``'s gentle drift: a few rows per frame."""
    base = _base()
    out = []
    for i in range(frames):
        m = base.copy()
        m[:3, 3] += i * np.array([0.3, 0.5, -1.0])
        out.append(m)
    return np.stack(out).astype(np.float32)


def _seeded(frames=4, seed=7):
    """A seeded flight: small random turns and moves per frame."""
    rng = np.random.default_rng(seed)
    m = _base()
    out = [m]
    for _ in range(frames - 1):
        a = rng.normal(0.0, 0.05, 3)
        cx, sx, cy, sy = np.cos(a[0]), np.sin(a[0]), np.cos(a[1]), np.sin(a[1])
        r = np.eye(4)
        r[:3, :3] = (np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                     @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))
        r[:3, 3] = rng.normal(0.0, 2.0, 3)
        m = m @ r
        out.append(m)
    return np.stack(out).astype(np.float32)


def _jump():
    base = _base()
    m1 = base.copy()
    m1[:3, 3] += np.array([0.0, 60.0, 0.0])
    return np.stack([base, m1]).astype(np.float32)


FLIGHTS = {"drift": _drift, "pitch": lambda: np.stack([_base(), _pitched(_base(), 0.42)]).astype(
    np.float32), "seeded": _seeded, "jump": _jump}


# -- the host functions ---------------------------------------------------------------


@pytest.mark.parametrize("flight", list(FLIGHTS))
@pytest.mark.parametrize("h_local", [32, 64])
def test_halo_host_functions_equal_jax(flight, h_local):
    stack = FLIGHTS[flight]()
    jscene = jdemo.build_demo_scene("no_clouds")
    scene = tdemo.build_demo_scene("no_clouds", device="cpu")
    jcam, cam = jdemo.demo_camera("space"), tdemo.demo_camera("space", device="cpu")
    depths = [0.5, 4.0, 250.0, 1.0e7]
    assert tsh.reprojection_row_bound(stack, 1.2, H, W, depths) == jsh.reprojection_row_bound(
        stack, 1.2, H, W, depths)
    assert (tsh._scene_min_depth(scene.opaque, stack, 0.1)
            == jsh._scene_min_depth(jscene.opaque, stack, 0.1))
    assert tsh._scene_min_depth(None, stack, 0.1) == jsh._scene_min_depth(None, stack, 0.1)
    got = tsh.derive_taa_halo(stack, cam, H, W, h_local, opaque=scene.opaque)
    assert got == jsh.derive_taa_halo(stack, jcam, H, W, h_local, opaque=jscene.opaque)
    assert got[0] % 8 == 0 and 8 <= got[0] <= h_local


# -- the refusals ---------------------------------------------------------------------


def _flight_call(package, height, mesh_size, **kw):
    """A sharded TAA flight of ``no_clouds`` in either package (both refuse
    before rendering)."""
    if package == "jax":
        scene = jdemo.build_demo_scene("no_clouds")
        return scene.render_flight(jdemo.demo_camera("space"), TIMES, height, W,
                                   cam_transforms=_drift(), interpret=True, taa_blend=0.2,
                                   mesh=jsh.make_mesh(jax.devices()[:mesh_size]), **kw)
    scene = tdemo.build_demo_scene("no_clouds", device="cpu")
    return scene.render_flight(tdemo.demo_camera("space", device="cpu"), TIMES, height, W,
                               cam_transforms=_drift(), taa_blend=0.2,
                               mesh=tsh.make_mesh(mesh_size), **kw)


def _frame_call(package, variant, height, mesh_size):
    """A sharded single-layer megakernel frame in either package."""
    if package == "jax":
        scene = jdemo.build_demo_scene(variant)
        cam = jdemo.demo_camera("avatar")
        scene.update(0.5, cam)
        a = scene.atmospheres[0]
        return jsh.render_frame_pallas_sharded(
            a.build_params(), a.effective_config(), cam, scene.opaque, height, W,
            jsh.make_mesh(jax.devices()[:mesh_size]), interpret=True)
    scene = tdemo.build_demo_scene(variant, device="cpu")
    cam = tdemo.demo_camera("avatar", device="cpu")
    scene.update(0.5, cam)
    a = scene.atmospheres[0]
    return tsh.render_frame_megakernel_sharded(a.build_params(), a.effective_config(), cam,
                                               scene.opaque, height, W, tsh.make_mesh(mesh_size))


REFUSALS = {
    "height_not_divisible": lambda p: _frame_call(p, "no_clouds", 100, 3),
    "lod_group_split": lambda p: _frame_call(p, "clouds_high", 120, 4),  # 30 rows, group 4
    "rows_per_shard_not_32": lambda p: _flight_call(p, 96, 2),  # 48 rows
    "halo_not_multiple_of_8": lambda p: _flight_call(p, H, 2, taa_halo=12),
    "halo_beyond_shard": lambda p: _flight_call(p, H, 4, taa_halo=64),  # 32 rows
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_jax(case):
    for package in ("jax", "port"):
        with pytest.raises(ValueError):
            REFUSALS[case](package)


def test_mesh_refusals():
    with pytest.raises(ValueError):
        tsh.make_mesh(0)
    scene = tdemo.build_demo_scene("no_clouds", device="cpu")
    cam = tdemo.demo_camera("space", device="cpu")
    a = scene.atmospheres[0]
    with pytest.raises(ValueError):  # the mesh renders on another device than the inputs
        tsh.render_frame_megakernel_sharded(a.build_params(), a.config, cam, scene.opaque, 64,
                                            W, tsh.make_mesh(2, device="meta"))
    assert list(tsh.make_mesh(3).shards()) == [0, 1, 2]


# -- the band chain against JAX render_scene_band_pallas ------------------------------


def _panorama(seed, h=128, w=256):
    coarse = np.random.default_rng(seed).random((3, h // 16, w // 16)).astype(np.float32)
    up = torch.nn.functional.interpolate(_t(coarse)[None], size=(h, w), mode="bilinear",
                                         align_corners=False)[0]
    return np.ascontiguousarray(0.5 * up.permute(1, 2, 0).numpy())


def _moon_scenes(variant, pano):
    """The demo scene with a far moon (and ``pano`` as its sky, if given) in
    both packages, at the avatar pose."""
    jscene = jdemo.build_demo_scene(variant)
    scene = tdemo.build_demo_scene(variant, device="cpu")
    if pano is not None:
        jscene.opaque = dataclasses.replace(jscene.opaque, panorama=pano)
        scene.opaque = dataclasses.replace(scene.opaque, panorama=_t(pano))
    jscene.atmospheres.append(JAtmo(sun=jscene.atmospheres[0].sun, custom_shader="no_clouds",
                                    **MOON))
    scene.atmospheres.append(TAtmo(sun=scene.atmospheres[0].sun, custom_shader="no_clouds",
                                   device="cpu", **MOON))
    jcam, cam = jdemo.demo_camera("avatar"), tdemo.demo_camera("avatar", device="cpu")
    jscene.update(0.5, jcam)
    scene.update(0.5, cam)
    return (jscene, jcam), (scene, cam)


@pytest.mark.parametrize("variant", ["clouds_high", "no_clouds"])
def test_band_chain_matches_jax_interpret(variant):
    h, w, n = 64, 128, 2
    (jscene, jcam), (scene, cam) = _moon_scenes(variant, _panorama(3))
    _, jparams, jconfigs = jscene._sorted_layers(jcam)
    _, params, configs = scene._sorted_layers(cam)
    assert [c.clouds_enabled for c in configs] == [False, variant != "no_clouds"]  # moon first
    jpdata, jpmeta = jscene._pano_plan()
    pdata, pmeta = scene._pano_plan()
    bands = []
    for s in range(n):
        r0 = s * (h // n)
        ref = _image(render_scene_band_pallas(jparams, jconfigs, jcam, jscene.opaque, h, w, r0,
                                              h // n, interpret=True, pano_data=jpdata,
                                              pano_meta=jpmeta))
        mk.counters.reset()
        out = mk.render_scene_band_megakernel(params, configs, cam, scene.opaque, h, w, r0,
                                              h // n, pano_data=pdata, pano_meta=pmeta)
        assert (mk.counters.plain_calls, mk.counters.megakernel_launches) == (1, 0)
        assert set(out) == {"color", "alpha", "linear_depth"}
        got = _image({k: v.numpy() for k, v in out.items()})
        assert got.shape == (h // n, w, 4) and np.isfinite(got).all()
        if variant == "no_clouds":
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
        else:
            assert _cloud_ok(got, ref), s
        bands.append(out)
    # the assembled bands are the port's whole frame (32-row shards: the
    # sky's tiles are the frame's)
    full = render_scene(params, configs, cam, scene.opaque, h, w, pano_data=pdata,
                        pano_meta=pmeta)
    for k in ("color", "alpha", "linear_depth"):
        assert torch.equal(torch.cat([b[k] for b in bands]), full[k]), k
    sharded = tsh.render_scene_megakernel_sharded(params, configs, cam, scene.opaque, h, w,
                                                  tsh.make_mesh(n), pano_data=pdata,
                                                  pano_meta=pmeta)
    assert torch.equal(sharded["color"], full["color"])
    assert torch.equal(sharded["alpha"], full["alpha"])


def test_render_frame_sharded_matches_jax_xla():
    """Both layers of the moon scene (no panorama: the XLA path samples it
    exactly) on 4 shards of 16 rows."""
    h, w = 64, 128
    (jscene, jcam), (scene, cam) = _moon_scenes("no_clouds", None)
    _, jparams, jconfigs = jscene._sorted_layers(jcam)
    _, params, configs = scene._sorted_layers(cam)
    ref = np.asarray(jsh.render_frame_sharded(jparams, jconfigs, jcam, jscene.opaque, h, w,
                                              jsh.make_mesh(jax.devices()[:4])))
    got = tsh.render_frame_sharded(params, configs, cam, scene.opaque, h, w,
                                   tsh.make_mesh(4)).numpy()
    assert got.shape == (h, w, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


# -- the sharded TAA flight -------------------------------------------------------------


def test_sharded_taa_flight_matches_jax_sharded_flight():
    stack = _drift()
    jscene = jdemo.build_demo_scene("no_clouds")
    ref = jscene.render_flight(jdemo.demo_camera("space"), TIMES, H, W, cam_transforms=stack,
                               interpret=True, taa_blend=0.2,
                               mesh=jsh.make_mesh(jax.devices()[:4]))
    scene = tdemo.build_demo_scene("no_clouds", device="cpu")
    mk.counters.reset()
    taa.counters.reset()
    out = scene.render_flight(tdemo.demo_camera("space", device="cpu"), TIMES, H, W,
                              cam_transforms=stack, taa_blend=0.2, mesh=tsh.make_mesh(4))
    k = len(TIMES)
    assert (mk.counters.plain_calls, taa.counters.plain_calls) == (4 * k, 4 * k)
    assert mk.counters.megakernel_launches == 0 and taa.counters.launches == 0
    s, f = out["color"].numpy(), np.asarray(ref["color"])
    assert s.shape == f.shape == (k, H, W, 3) and np.isfinite(s).all()
    # JAX's envelope between its sharded and single-device flights; the two
    # packages themselves agree at tests/test_pallas.py's bound (measured:
    # max 1.8e-5, 0.02 % of pixels past atol 1e-5 + rtol 1e-4, the same as
    # their single-device flights)
    d = np.abs(s - f)
    assert d.max() < 1e-4, f"max delta {d.max():.2e}"
    assert (d > 1e-5 + 1e-4 * np.abs(f)).any(-1).mean() < 0.005
    assert np.abs(out["alpha"].numpy() - np.asarray(ref["alpha"])).max() < 1e-4
    # and the port's sharded flight meets JAX's envelope against its own
    # single-device flight (ulp-level TAA validity flips at isolated pixels)
    single = scene.render_flight(tdemo.demo_camera("space", device="cpu"), TIMES, H, W,
                                 cam_transforms=stack, taa_blend=0.2)["color"].numpy()
    d = np.abs(s - single).max(-1)
    assert d.max() < 1e-4 and (d > 1e-6).mean() < 0.005


def test_halo_warns_when_rows_per_shard_cap_it():
    """A huge vertical jump: the derived halo is clamped to the rows per
    shard and says so; frame 0 (no history) is the plain render."""
    scene = tdemo.build_demo_scene("no_clouds", device="cpu")
    cam = tdemo.demo_camera("space", device="cpu")
    times = TIMES[:2]
    with pytest.warns(tsh.TaaHaloWarning, match="rows-per-shard caps"):
        shard = scene.render_flight(cam, times, H, W, cam_transforms=_jump(), taa_blend=0.2,
                                    mesh=tsh.make_mesh(4))
    single = scene.render_flight(cam, times, H, W, cam_transforms=_jump(), taa_blend=0.2)
    assert torch.isfinite(shard["color"]).all()
    np.testing.assert_allclose(shard["color"][0].numpy(), single["color"][0].numpy(), atol=1e-5)


def test_halo_warns_beyond_the_configured_halo():
    """The pitched flight reprojects ~40 rows: the derived halo keeps the
    single-device accumulation around the shard boundary, a halo of 32
    warns and loses it there (``tests/test_sharding_taa.py:153-200``)."""
    scene = tdemo.build_demo_scene("no_clouds", device="cpu")
    cam = tdemo.demo_camera("space", device="cpu")
    stack = FLIGHTS["pitch"]()
    times = TIMES[:2]
    auto = scene.render_flight(cam, times, H, W, cam_transforms=stack, taa_blend=0.2,
                               mesh=tsh.make_mesh(2))
    with pytest.warns(tsh.TaaHaloWarning, match="beyond the configured halo"):
        fixed = scene.render_flight(cam, times, H, W, cam_transforms=stack, taa_blend=0.2,
                                    mesh=tsh.make_mesh(2), taa_halo=32)
    single = scene.render_flight(cam, times, H, W, cam_transforms=stack, taa_blend=0.2)
    band = slice(48, 80)
    a, fx, sg = (x["color"][1, band].numpy() for x in (auto, fixed, single))
    assert np.abs(a - sg).max() < 1e-4
    d_fixed = np.abs(fx - sg).max(-1)
    assert d_fixed.max() > 1e-3 and (d_fixed > 1e-4).mean() > 0.01
