"""Large-world (camera-relative) rendering: the port against the JAX
package on the CPU.

The Earth-scale scene of ``tests/test_large_world.py`` (R = 6.371e6, the
camera 60 km up looking at the limb) is built in both packages at 48×64.
Every world position the device sees is rebased around the camera in host
float64 before the cast to float32, so the scene translated by (3e7, 1e7,
−2e7) renders the frame at the origin (≤ 1e-5; measured bitwise equal) and
the frame JAX renders there (cloud-free: atol 1e-5, rtol 1e-4, the JAX
XLA frame run eagerly).  Without the rebase the translated frame is worse
by more than 10×.  A flight takes one origin, its first frame's camera.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models import scene as jscene
from godot_atmosphere_shader_tpu.render.opaque import OpaqueScene as JOpaque
from godot_atmosphere_shader_tpu.utils import camera as jcam
from godot_atmosphere_shader_tpu_torch.models import scene as tscene
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from godot_atmosphere_shader_tpu_torch.render.opaque import OpaqueScene
from godot_atmosphere_shader_tpu_torch.utils.camera import Camera, look_at

torch.set_num_threads(2)

R_EARTH = 6.371e6
H_ATMO = 1.0e5
SIZE = (48, 64)
OFFSET = (3.0e7, 1.0e7, -2.0e7)


@pytest.fixture
def eager_jax(monkeypatch):
    """The JAX package's XLA path run op by op: ``jax.disable_jit`` with a
    ``fori_loop`` that hands its body an int32 index, as the traced loop
    does."""
    def fori_loop(lower, upper, body, init, **kwargs):
        val = init
        for i in range(int(lower), int(upper)):
            val = body(jnp.int32(i), val)
        return val

    monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)
    with jax.disable_jit():
        yield


def _earth(pkg, offset, large_world=None):
    """``tests/test_large_world.py``'s scene in either package (``pkg``:
    ``"jax"`` or ``"port"``)."""
    offset = np.asarray(offset, np.float64)
    mod, opq, cam_mod = ((jscene, JOpaque, jcam) if pkg == "jax"
                         else (tscene, OpaqueScene, None))
    kw = {} if pkg == "jax" else {"device": "cpu"}
    sun = mod.Node3D(position=offset + np.array([1.5e8, 0.0, 0.0]))
    atmo = mod.PlanetAtmosphere(planet_radius=R_EARTH, atmosphere_height=H_ATMO, sun=sun,
                                custom_shader="no_clouds", position=offset, density=0.005,
                                scattering_strength=1.0, **kw)
    opaque = opq.create(spheres=[(offset, R_EARTH, (0.25, 0.22, 0.2))],
                        light_dir=(-1.0, 0.0, 0.0), sky_color=(0.0, 0.0, 0.0), **kw)
    scene = mod.Scene([atmo], opaque, large_world=large_world, **kw)
    eye = offset + np.array([0.0, R_EARTH + 6.0e4, 0.0])
    target = offset + np.array([2.0e6, R_EARTH - 1.0e5, 0.0])
    if pkg == "jax":
        cam = cam_mod.Camera.create(cam_mod.look_at(eye, target), fov_y_deg=70.0, near=10.0,
                                    far=1.0e8)
    else:
        cam = Camera.create(look_at(eye, target), fov_y_deg=70.0, near=10.0, far=1.0e8,
                            device="cpu")
    return scene, cam


def _render(offset, large_world=None):
    scene, cam = _earth("port", offset, large_world)
    scene.update(0.0, cam)
    mk.counters.reset()
    out = scene.render(cam, *SIZE)
    assert mk.counters.plain_calls == 1
    return out["color"].numpy(), out["alpha"].numpy()


def test_auto_activation():
    scene, cam = _earth("port", (0.0, 0.0, 0.0))
    assert cam.view_to_world.dtype == torch.float64  # look_at kept float64
    cam_pos = scene._cam_pos(cam)
    assert np.max(np.abs(cam_pos)) > tscene.LARGE_WORLD_THRESHOLD
    assert scene._large_world_active(cam_pos)
    small = tscene.Scene([tscene.PlanetAtmosphere(device="cpu")], None, device="cpu")
    assert not small._large_world_active(np.zeros(3))
    jsc, jc = _earth("jax", (0.0, 0.0, 0.0))
    assert jsc._large_world_active(np.asarray(jc.view_to_world)[:3, 3])


def test_camera_is_rebased_to_origin():
    scene, cam = _earth("port", OFFSET)
    scene.update(0.0, cam)
    cam_rel, opaque_rel = scene._rebased_view(cam)
    assert cam_rel.view_to_world.dtype == torch.float32
    assert float(cam_rel.view_to_world[:3, 3].abs().max()) == 0.0  # the origin IS the camera
    assert float(opaque_rel.sphere_centers.abs().max()) < 2 * R_EARTH
    assert scene._rebased_view(cam)[1] is opaque_rel  # one rebased scene per origin
    w2m = scene.atmospheres[0]._params.frame_state[3:19].reshape(4, 4).double().numpy()
    assert np.max(np.abs(np.linalg.inv(w2m)[:3, 3])) < 2 * R_EARTH
    # the same numbers as the JAX package's rebase
    jsc, jc = _earth("jax", OFFSET)
    jsc.update(0.0, jc)
    jrel, jop = jsc._rebased_view(jc)
    np.testing.assert_array_equal(cam_rel.view_to_world.numpy(), np.asarray(jrel.view_to_world))
    np.testing.assert_array_equal(opaque_rel.sphere_centers.numpy(),
                                  np.asarray(jop.sphere_centers))
    np.testing.assert_array_equal(scene.atmospheres[0]._params.frame_state.numpy(),
                                  np.asarray(jsc.atmospheres[0]._params.frame_state))


def test_translation_invariance_at_3e7(eager_jax):
    rgb0, a0 = _render((0.0, 0.0, 0.0))
    rgb1, a1 = _render(OFFSET)
    assert np.isfinite(rgb1).all() and float(a0.mean()) > 0.05
    assert float(np.abs(rgb1 - rgb0).max()) <= 1e-5
    assert float(np.abs(a1 - a0).max()) <= 1e-5
    jsc, jc = _earth("jax", OFFSET)
    jsc.update(0.0, jc)
    ref = jsc.render(jc, *SIZE, renderer="xla")
    np.testing.assert_allclose(rgb1, np.asarray(ref["color"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a1, np.asarray(ref["alpha"]), rtol=1e-4, atol=1e-5)


def test_rebase_beats_raw_f32():
    off = (2.56e8, 1.0e8, -1.6e8)  # float32 spacing 16-32 out here
    rgb0, _ = _render((0.0, 0.0, 0.0), large_world=True)
    rgb_lw, _ = _render(off, large_world=True)
    rgb_raw, _ = _render(off, large_world=False)
    err_lw = float(np.abs(rgb_lw - rgb0).mean())
    err_raw = float(np.abs(rgb_raw - rgb0).mean())
    assert err_raw > 10.0 * max(err_lw, 1e-7)


def test_flight_rebase_single_origin():
    """A flight rebases every frame by its first frame's camera: the
    transforms and frame states it renders are the per-frame renders' at
    that origin, so each frame equals ``Scene.render`` with the same
    origin."""
    scene, cam = _earth("port", OFFSET)
    m0 = cam.view_to_world.numpy()
    m1 = m0.copy()
    m1[:3, 3] += np.array([200.0, 0.0, 0.0])  # a 200 m hop
    out = scene.render_flight(cam, [0.0, 0.1], *SIZE, cam_transforms=np.stack([m0, m1]))
    np.testing.assert_array_equal(scene._rebase_origin, m0[:3, 3])
    arr = out["color"].numpy()
    assert np.isfinite(arr).all() and arr.shape[0] == 2
    assert float(np.abs(arr[1] - arr[0]).mean()) < 5e-2
    # frame 0 is the still frame at the same origin and time
    scene.update(0.0, cam)
    still = scene.render(cam, *SIZE)["color"].numpy()
    np.testing.assert_array_equal(arr[0], still)


def test_small_scenes_unaffected():
    """Demo-scale scenes never rebase (auto-off)."""
    atmo = tscene.PlanetAtmosphere(planet_radius=100.0, atmosphere_height=8.0,
                                   custom_shader="no_clouds", device="cpu")
    scene = tscene.Scene([atmo], OpaqueScene.create(
        spheres=[((0.0, 0.0, 0.0), 100.0, (0.3, 0.3, 0.3))], device="cpu"), device="cpu")
    cam = Camera.create(look_at((0.0, 150.0, 420.0), (0.0, 0.0, 0.0), device="cpu"),
                        far=2000.0, device="cpu")
    scene.update(0.0, cam)
    assert scene._rebase_origin is None
    cam_out, opaque_out = scene._rebased_view(cam)
    assert cam_out is cam and opaque_out is scene.opaque
