"""The far→near layer chain: the port's plain ``render_scene`` and its
two-layer flight against the JAX package.

The scene is ``tests/test_lod.py``'s: the demo planet (``no_clouds``) and
the moon's atmosphere at the space pose, 64×128.  The JAX side is the
Pallas chain ``render_scene_pallas`` in interpret mode (fullscreen, and with
hand-placed bands: the moon on rows [32, 64), or also the planet on
[0, 64), which takes the opaque-only pass), and its XLA flight.  Cloud-free
tolerance: atol 1e-5 with rtol 1e-4 (``tests/test_pallas.py:38``); a banded
chain equals the fullscreen one at atol 2e-6 (``tests/test_lod.py:206``).
"""

import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models import demo as jdemo
from godot_atmosphere_shader_tpu.models.scene import PlanetAtmosphere as JAtmo
from godot_atmosphere_shader_tpu.ops.pallas.megakernel import render_scene_pallas
from godot_atmosphere_shader_tpu_torch.models import demo as tdemo
from godot_atmosphere_shader_tpu_torch.models.scene import PlanetAtmosphere as TAtmo
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from godot_atmosphere_shader_tpu_torch.render.renderer import render_scene

torch.set_num_threads(2)

H, W = 64, 128
MOON = dict(planet_radius=10.0, atmosphere_height=2.0, position=(-188.991, 0.0, 192.584))
#: (bands, first rows) per plan: fullscreen; the moon banded; both banded
PLANS = {"fullscreen": (None, None), "moon_band": ((None, 32), [0, 32]),
         "both_bands": ((64, 32), [0, 32])}


def _jax_scene():
    scene = jdemo.build_demo_scene("no_clouds")
    scene.atmospheres.append(JAtmo(sun=scene.atmospheres[0].sun, custom_shader="no_clouds",
                                   **MOON))
    return scene


def _port_scene():
    scene = tdemo.build_demo_scene("no_clouds", device="cpu")
    scene.atmospheres.append(TAtmo(sun=scene.atmospheres[0].sun, custom_shader="no_clouds",
                                   device="cpu", **MOON))
    return scene


def _image(out):
    return np.concatenate([np.asarray(out["color"]), np.asarray(out["alpha"])[..., None]], -1)


@pytest.fixture(scope="module")
def jax_frames():
    scene = _jax_scene()
    cam = jdemo.demo_camera("space")
    scene.update(0.0, cam)
    _, params, configs = scene._sorted_layers(cam)
    out = {}
    for name, (bands, rows) in PLANS.items():
        out[name] = _image(render_scene_pallas(
            params, configs, cam, scene.opaque, H, W, interpret=True, bands=bands,
            band_rows=None if rows is None else np.asarray(rows, np.int32)))
    return out


def _port_frame(bands, rows):
    scene = _port_scene()
    cam = tdemo.demo_camera("space", device="cpu")
    scene.update(0.0, cam)
    order, params, configs = scene._sorted_layers(cam)
    assert [a.name for a in order] == ["PlanetAthmosphere", "PlanetAtmosphere"]  # far → near
    return _image({k: v.numpy() for k, v in render_scene(
        params, configs, cam, scene.opaque, H, W, bands=bands, band_rows=rows).items()})


@pytest.mark.parametrize("plan", list(PLANS))
def test_chain_matches_jax_pallas_chain(jax_frames, plan):
    got = _port_frame(*PLANS[plan])
    assert np.isfinite(got).all() and got[..., 3].max() > 0.1
    np.testing.assert_allclose(got, jax_frames[plan], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("plan", ["moon_band", "both_bands"])
def test_banded_chain_equals_fullscreen(plan):
    np.testing.assert_allclose(_port_frame(*PLANS[plan]), _port_frame(None, None), atol=2e-6)


def test_chain_wrapper_counts_one_plain_frame_and_refuses_bad_plans():
    scene = _port_scene()
    cam = tdemo.demo_camera("space", device="cpu")
    scene.update(0.0, cam)
    _, params, configs = scene._sorted_layers(cam)
    mk.counters.reset()
    out = mk.render_scene_megakernel(params, configs, cam, scene.opaque, H, W,
                                     bands=(None, 32), band_rows=[0, 32])
    assert (mk.counters.plain_calls, mk.counters.megakernel_launches) == (1, 0)
    assert set(out) == {"color", "alpha"}
    with pytest.raises(ValueError):  # a band past the frame's last row
        mk.render_scene_megakernel(params, configs, cam, scene.opaque, H, W,
                                   bands=(None, 64), band_rows=[0, 32])
    with pytest.raises(ValueError):  # one band entry for two layers
        mk.render_scene_megakernel(params, configs, cam, scene.opaque, H, W, bands=(32,),
                                   band_rows=[0])


def test_launch_plan_of_a_banded_chain():
    """The card's launches for a chain whose layer 0 is banded: the
    opaque-only pass, then each layer chained over the frame on its rows."""
    scene = _port_scene()
    cam = tdemo.demo_camera("space", device="cpu")
    scene.update(0.0, cam)
    _, params, configs = scene._sorted_layers(cam)
    plan = mk.scene_launches(params, configs, cam, scene.opaque, H, W, bands=(64, 32),
                             band_rows=[0, 32])
    got = [(k, s.row0, s.rows, s.with_atmosphere, s.with_background, s.with_opaque)
           for k, s, _ in plan]
    assert got == [("opaque", 0, H, 0, 0, 1), ("band", 0, 64, 1, 1, 0),
                   ("band", 32, 32, 1, 1, 0)]
    full = mk.scene_launches(params, configs, cam, scene.opaque, H, W)
    assert [(k, s.with_background, s.with_opaque) for k, s, _ in full] == [
        ("layer", 0, 1), ("layer", 1, 0)]


def test_two_layer_flight_matches_jax_xla_flight():
    """The plain two-layer flight (every layer fullscreen, far to near)
    against the JAX XLA flight along a short path from the space pose."""
    times = [0.0, 1 / 60, 2 / 60]
    stack = np.stack([np.asarray(jdemo.look_at((0.4 * i, 150.0, 420.0 - 0.6 * i),
                                               (0.0, 0.0, 0.0)), np.float32)
                      for i in range(3)])
    jscene = _jax_scene()
    ref = jscene.render_flight(jdemo.demo_camera("space"), times, H, W, cam_transforms=stack,
                               renderer="xla")
    scene = _port_scene()
    mk.counters.reset()
    got = scene.render_flight(tdemo.demo_camera("space", device="cpu"), times, H, W,
                              cam_transforms=stack)
    assert (mk.counters.plain_calls, mk.counters.megakernel_launches) == (3, 0)
    np.testing.assert_allclose(_image({k: v.numpy() for k, v in got.items()}), _image(ref),
                               rtol=1e-4, atol=1e-5)
