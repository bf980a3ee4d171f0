"""Far-mode row bands: the port's ``render/lod.py`` and ``Scene._layer_bands``
against the JAX package's, and the band's jitter and ray rows.

The band geometry is host float64 numpy on both sides, so the results must
be equal exactly: the same tuples, ``None`` or ``EMPTY``.
"""

import math

import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models import demo as jdemo
from godot_atmosphere_shader_tpu.models.scene import PlanetAtmosphere as JAtmo
from godot_atmosphere_shader_tpu.render import lod as jlod
from godot_atmosphere_shader_tpu.render.jitter import jitter_plane as jax_jitter_plane
from godot_atmosphere_shader_tpu_torch.models import demo as tdemo
from godot_atmosphere_shader_tpu_torch.models.scene import MODE_FAR, MODE_NEAR
from godot_atmosphere_shader_tpu_torch.models.scene import PlanetAtmosphere as TAtmo
from godot_atmosphere_shader_tpu_torch.render import lod as tlod
from godot_atmosphere_shader_tpu_torch.render.jitter import jitter_plane
from godot_atmosphere_shader_tpu_torch.utils.camera import pixel_ndc

MOON = dict(planet_radius=10.0, atmosphere_height=2.0, position=(-188.991, 0.0, 192.584))


def _look_at(eye, target, up=(0.0, 1.0, 0.0)):
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, np.cross(right, fwd), -fwd, eye
    return m


def _poses(n, seed):
    """Seeded camera poses and spheres: in front, behind, straddling the
    camera plane, inside the sphere, above and below the frame."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        eye = rng.uniform(-500.0, 500.0, 3)
        target = eye + rng.normal(size=3)
        center = eye + rng.normal(size=3) * rng.choice([20.0, 200.0, 1000.0])
        radius = float(rng.choice([0.5, 5.0, 50.0, 400.0]) * rng.uniform(0.5, 2.0))
        fov = math.radians(float(rng.uniform(30.0, 100.0)))
        height = int(rng.choice([64, 96, 256, 1080]))
        yield _look_at(eye, target), fov, height, center, radius


def test_constants_match_jax():
    assert (tlod.BAND_QUANTUM, tlod.BAND_MARGIN_ROWS, tlod.EMPTY) == (
        jlod.BAND_QUANTUM, jlod.BAND_MARGIN_ROWS, jlod.EMPTY)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_projected_row_band_matches_jax(seed):
    kinds = set()
    for v2w, fov, height, center, radius in _poses(150, seed):
        got = tlod.projected_row_band(v2w, fov, height, center, radius)
        want = jlod.projected_row_band(v2w, fov, height, center, radius)
        assert got == want, (v2w, fov, height, center, radius)
        kinds.add("band" if isinstance(got, tuple) else str(got))
        if isinstance(got, tuple):
            row0, band_h = got
            assert row0 % 8 == 0 and band_h % tlod.BAND_QUANTUM == 0
            assert 0 <= row0 and row0 + band_h <= height
    assert kinds == {"band", "None", tlod.EMPTY}


@pytest.mark.parametrize("mode", [MODE_NEAR, MODE_FAR])
def test_layer_band_matches_jax(mode):
    for v2w, fov, height, center, radius in _poses(60, 7):
        args = (v2w, fov, height, center, radius * 0.9, radius * 0.1)
        assert tlod.layer_band(mode, *args, mode_far=MODE_FAR) == jlod.layer_band(
            mode, *args, mode_far=MODE_FAR)


def test_scene_layer_bands_plan_matches_jax():
    """``tests/test_lod.py``'s scene: the demo planet, the moon's
    atmosphere and a third shell far behind the camera (dropped)."""
    jscene = jdemo.build_demo_scene("no_clouds")
    tscene = tdemo.build_demo_scene("no_clouds", device="cpu")
    jscene.atmospheres.append(JAtmo(sun=jscene.atmospheres[0].sun, custom_shader="no_clouds",
                                    **MOON))
    tscene.atmospheres.append(TAtmo(sun=tscene.atmospheres[0].sun, custom_shader="no_clouds",
                                    device="cpu", **MOON))
    jcam = jdemo.demo_camera("space")
    tcam = tdemo.demo_camera("space", device="cpu")
    v2w = np.asarray(jcam.view_to_world)
    behind = tuple(v2w[:3, 3] + 500.0 * v2w[:3, 2])
    jscene.atmospheres.append(JAtmo(planet_radius=5.0, atmosphere_height=1.0,
                                    custom_shader="no_clouds", position=behind))
    tscene.atmospheres.append(TAtmo(planet_radius=5.0, atmosphere_height=1.0,
                                    custom_shader="no_clouds", position=behind, device="cpu"))
    for height in (96, 256, 1080):
        plans = []
        for scene, cam in ((jscene, jcam), (tscene, tcam)):
            scene.update(0.0, cam)
            order, params, configs = scene._sorted_layers(cam)
            res = scene._layer_bands(order, params, tuple(configs), (None,) * len(configs),
                                     cam, height)
            plans.append(([a.name for a in res[0]], [a.extra_cull_margin for a in res[0]],
                          res[4], None if res[5] is None else res[5].tolist()))
        assert plans[0] == plans[1], height
    assert len(plans[1][0]) == 2 and plans[1][2] is not None  # at 1080: both banded


def test_every_layer_culled_keeps_the_nearest_fullscreen():
    scene = tdemo.build_demo_scene("no_clouds", device="cpu")
    cam = tdemo.demo_camera("space", device="cpu")
    v2w = cam.view_to_world.numpy().astype(np.float64)
    scene.atmospheres[0].transform[:3, 3] = v2w[:3, 3] + 800.0 * v2w[:3, 2]
    scene.atmospheres.append(TAtmo(planet_radius=5.0, atmosphere_height=1.0, device="cpu",
                                   position=tuple(v2w[:3, 3] + 300.0 * v2w[:3, 2])))
    scene.update(0.0, cam)
    order, params, configs = scene._sorted_layers(cam)
    res = scene._layer_bands(order, params, configs, (None, None), cam, 256)
    assert res[0] == (order[-1],) and res[4] is None and res[5] is None


def test_cull_margin_follows_the_radii():
    atmo = TAtmo(planet_radius=100.0, atmosphere_height=8.0, device="cpu")
    assert atmo.extra_cull_margin == 108.0
    atmo.planet_radius = 90.5
    atmo.atmosphere_height = 4.25
    assert atmo.extra_cull_margin == 94.75


@pytest.mark.parametrize("row0,rows", [(0, 64), (40, 192), (232, 64), (688, 128)])
def test_band_jitter_is_the_full_frame_jitter_slice(row0, rows):
    """The kernel reads the blue noise at the global row; the plain band
    takes the same rows, which equal the JAX slice of the full-frame
    jitter plane (the tiling is 256-periodic)."""
    height, width = 1080, 384
    full = jitter_plane(height, width, device="cpu")
    band = jitter_plane(rows, width, device="cpu", row0=row0)
    assert torch.equal(band, full[row0:row0 + rows])
    want = np.asarray(jax_jitter_plane(height, width))[row0:row0 + rows]
    np.testing.assert_array_equal(band.numpy(), want)


def test_band_rays_are_the_full_frame_rows():
    nx, ny = pixel_ndc(256, 384, device="cpu")
    bx, by = pixel_ndc(256, 384, device="cpu", rows=64, row0=72)
    assert torch.equal(bx, nx) and torch.equal(by, ny[72:136])
