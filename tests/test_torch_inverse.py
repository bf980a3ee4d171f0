"""Inverse rendering: the port's ``models/inverse.py`` and its row-sharded
training step (``parallel/sharding.py::train_step_sharded``) against the
JAX package on the same inputs, on the CPU.

* ``loss_and_gradients`` against ``jax.value_and_grad`` of the JAX fitter's
  loss (``render_frame_impl``) over all seven ``DEFAULT_TRAINABLE`` knobs:
  ``no_clouds``/exterior at 48² (JAX jitted) with each element of each
  knob's gradient within 1e-4 of its own |g| plus 1e-5 of the largest |g|
  over the knobs; ``clouds_high``/avatar at 32×128 (JAX run eagerly, ~40 s,
  the file's one cloud case against JAX) within 1e-3 and 1e-4 in the same
  form (measured: 3.2e-4 of |g| on ``cloud_shape_factor``, the worst).
* The first steps of ``fit_step`` against JAX's, while every knob's |g|
  stands well above its rounding: the scalar knobs take the same ±lr sign
  step bit for bit, the 3-vector knobs agree within 1e-6.
* A twin of ``tests/test_inverse.py::test_fit_recovers_density``: its
  assertions, and the per-step losses within rtol 1e-4 of JAX's (the
  trajectories take the same sign steps; the losses round apart).
* Every knob's gradient is finite on every variant and pose of the demo
  (three poses with the raymarched sun light).
* The sharded step: a 2-shard local mesh equals the unsharded step
  (loss and gradients rtol 1e-5: the mean of equal shard means against the
  whole frame's mean); ``no_clouds``/exterior at 16×128 against
  ``jax.value_and_grad`` of ``dryrun_multichip``'s loss (the mean over
  shard means on a 2-device mesh) as above; the dryrun's own config,
  ``clouds``/space, sharded against unsharded (two gloo processes against
  the local mesh: ``tests/test_torch_sharding_gloo.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from godot_atmosphere_shader_tpu.models import demo as jdemo
from godot_atmosphere_shader_tpu.models import inverse as jinv
from godot_atmosphere_shader_tpu.parallel import sharding as jsh
from godot_atmosphere_shader_tpu.render.jitter import jitter_plane as jjitter
from godot_atmosphere_shader_tpu.render.renderer import render_frame as jrender
from godot_atmosphere_shader_tpu.render.renderer import render_frame_impl
from godot_atmosphere_shader_tpu.utils.camera import world_ray_dirs as jray_dirs
from godot_atmosphere_shader_tpu_torch import fit as tfit
from godot_atmosphere_shader_tpu_torch.models import demo as tdemo
from godot_atmosphere_shader_tpu_torch.models import inverse as tinv
from godot_atmosphere_shader_tpu_torch.models.convert import (atmosphere_params_from_numpy,
                                                              camera_from_numpy,
                                                              opaque_from_numpy,
                                                              variant_config_from_fields)
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from godot_atmosphere_shader_tpu_torch.parallel import sharding as tsh

torch.set_num_threads(2)

KNOBS = tinv.DEFAULT_TRAINABLE


def _fields(obj):
    return {f.name: None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _inputs(variant, pose, h, w):
    """The JAX demo scene's start point (density 0.2, scattering strength
    0.5) and its target (the port's plain frame of the true parameters),
    with their port twins from ``models/convert.py``."""
    scene = jdemo.build_demo_scene(variant=variant, procedural=True)
    cam = jdemo.demo_camera(pose)
    scene.update(0.0, cam)
    atmo = scene.atmospheres[0]
    true = atmo.build_params().resolve_frame_state()
    start = dataclasses.replace(true, density=jnp.float32(0.2),
                                scattering_strength=jnp.float32(0.5))
    t = {"params": atmosphere_params_from_numpy(_fields(start), device="cpu"),
         "true": atmosphere_params_from_numpy(_fields(true), device="cpu"),
         "config": variant_config_from_fields(dataclasses.asdict(atmo.config)),
         "camera": camera_from_numpy(_fields(cam), device="cpu"),
         "opaque": opaque_from_numpy(_fields(scene.opaque), device="cpu")}
    with torch.no_grad():
        t["target"] = mk.render_scene_plain((t["true"],), (t["config"],), t["camera"],
                                            t["opaque"], h, w)["color"]
    j = {"params": start, "true": true, "config": atmo.config, "camera": cam,
         "opaque": scene.opaque, "target": jnp.asarray(t["target"].numpy())}
    return j, t


def _train(params):
    return {k: getattr(params, k) for k in KNOBS}


def _np(tree):
    return {k: np.asarray(v, np.float64) for k, v in tree.items()}


def _assert_grads_close(got, ref, rel, of_max):
    """Each element of each knob's gradient within ``rel`` of its own |g|
    plus ``of_max`` of the largest |g| over every knob."""
    got, ref = _np(got), _np(ref)
    top = max(float(np.abs(v).max()) for v in ref.values())
    assert top > 0
    for k in KNOBS:
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], ref[k], rtol=rel, atol=of_max * top, err_msg=k)


def _jax_loss(j, h, w):
    def loss_fn(train):
        p = dataclasses.replace(j["params"], **train)
        out = render_frame_impl((p,), (j["config"],), j["camera"], j["opaque"], h, w)
        return jnp.mean((out["color"] - j["target"]) ** 2)

    return loss_fn


@pytest.fixture
def eager_jax(monkeypatch):
    def fori_loop(lower, upper, body, init, **kwargs):
        for i in range(int(lower), int(upper)):
            init = body(jnp.int32(i), init)
        return init

    monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)
    with jax.disable_jit():
        yield


# -- the fitter's loss and gradients ----------------------------------------------------


def test_no_clouds_gradients_match_jax():
    h = w = 48
    j, t = _inputs("no_clouds", "exterior", h, w)
    jl, jg = jax.jit(jax.value_and_grad(_jax_loss(j, h, w)))(_train(j["params"]))
    mk.counters.reset()
    loss, grads = tinv.loss_and_gradients(_train(t["params"]), t["params"], t["config"],
                                          t["camera"], t["opaque"], t["target"], h, w)
    assert (mk.counters.plain_calls, mk.counters.megakernel_launches) == (1, 0)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _assert_grads_close(grads, jg, 1e-4, 1e-5)
    # the cloud knobs have no path to a cloud-free frame: zeros, as in JAX
    for k in ("cloud_density_scale", "cloud_coverage_bias", "cloud_shape_factor"):
        assert float(jg[k]) == 0.0 and float(grads[k]) == 0.0, k


def test_cloud_gradients_match_jax(eager_jax):
    h, w = 32, 128
    j, t = _inputs("clouds_high", "avatar", h, w)
    jl, jg = jax.value_and_grad(_jax_loss(j, h, w))(_train(j["params"]))
    loss, grads = tinv.loss_and_gradients(_train(t["params"]), t["params"], t["config"],
                                          t["camera"], t["opaque"], t["target"], h, w)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert all(float(np.abs(np.asarray(jg[k])).max()) > 0 for k in KNOBS)
    _assert_grads_close(grads, jg, 1e-3, 1e-4)


POSES = ("avatar", "exterior", "interior", "space", "sunrise", "sunward")


@pytest.mark.parametrize("variant,poses", [
    ("no_clouds", POSES), ("clouds", POSES), ("clouds_high", POSES),
    ("clouds_high_rm", ("avatar", "interior", "sunrise")),  # ~3 s a pose: the sun march
    ("v1_no_clouds", POSES), ("v1_clouds", POSES)])
def test_gradients_are_finite(variant, poses):
    """The demo's poses at 8×64: the guarded ``sqrt``s and divisions keep
    every knob's gradient finite where the frame has masked lanes (rays
    that miss the planet or the cloud shell, the sun behind it)."""
    h, w = 8, 64
    scene = tdemo.build_demo_scene(variant=variant, device="cpu")
    for pose in poses:
        cam = tdemo.demo_camera(pose, device="cpu")
        scene.update(0.0, cam)
        atmo = scene.atmospheres[0]
        true = atmo.build_params().resolve_frame_state()
        with torch.no_grad():
            target = mk.render_scene_plain((true,), (atmo.config,), cam, scene.opaque, h,
                                           w)["color"]
        start = dataclasses.replace(true, density=torch.tensor(0.2),
                                    scattering_strength=torch.tensor(0.5))
        loss, grads = tinv.loss_and_gradients(_train(start), start, atmo.config, cam,
                                              scene.opaque, target, h, w)
        assert np.isfinite(float(loss)), pose
        for k in KNOBS:
            assert torch.isfinite(grads[k]).all(), (pose, k)
            assert grads[k].shape == getattr(start, k).shape, (pose, k)


# -- the fitter's steps ----------------------------------------------------------------


def test_first_steps_match_jax():
    """Three steps of all seven knobs: the scalar knobs' sign steps are
    equal bit for bit, the 3-vector knobs' normalised steps within 1e-6.
    Each knob's |g| stays above 1e-6 of the largest over these steps, far
    from its rounding, so both take the same steps."""
    h = w = 48
    j, t = _inputs("no_clouds", "exterior", h, w)
    jtrain, ttrain = _train(j["params"]), _train(t["params"])
    for step in range(3):
        jl, jtrain = jinv.fit_step(jtrain, j["params"], j["config"], j["camera"], j["opaque"],
                                   j["target"], h, w, lr=0.05)
        tl, ttrain = tinv.fit_step(ttrain, t["params"], t["config"], t["camera"], t["opaque"],
                                   t["target"], h, w, lr=0.05)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for k in KNOBS:
            got, ref = ttrain[k].numpy(), np.asarray(jtrain[k])
            assert not ttrain[k].requires_grad, k
            if got.ndim == 0:
                assert got == ref, (step, k, got, ref)
            else:
                np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=f"{step} {k}")


def test_fit_recovers_density():
    """``tests/test_inverse.py::test_fit_recovers_density`` through the
    port's ``fit`` (the package export), with JAX's losses beside it."""
    h = w = 48
    scene = jdemo.build_demo_scene(variant="no_clouds", procedural=True)
    cam = jdemo.demo_camera("exterior")
    scene.update(0.0, cam)
    atmo = scene.atmospheres[0]
    true = atmo.build_params().resolve_frame_state()
    jtarget = jrender((true,), (atmo.config,), cam, scene.opaque, h, w)["color"]
    start = dataclasses.replace(true, density=jnp.float32(0.25),
                                scattering_strength=jnp.float32(0.6))
    trainable = ("density", "scattering_strength")
    jfitted, jlosses = jinv.fit(start, atmo.config, cam, scene.opaque, jtarget, h, w,
                                steps=40, lr=0.1, trainable=trainable)

    fitted, losses = tfit(atmosphere_params_from_numpy(_fields(start), device="cpu"),
                          variant_config_from_fields(dataclasses.asdict(atmo.config)),
                          camera_from_numpy(_fields(cam), device="cpu"),
                          opaque_from_numpy(_fields(scene.opaque), device="cpu"),
                          torch.from_numpy(np.asarray(jtarget)), h, w, steps=40, lr=0.1,
                          trainable=trainable)
    assert losses[-1] < losses[0] * 0.2, losses[::10]
    # true density is 0.5 (demo scene); the fit should move toward it
    assert abs(float(fitted.density) - 0.5) < abs(0.25 - 0.5)
    assert np.isfinite(losses).all()
    assert len(losses) == 40 and all(isinstance(x, float) for x in losses)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert float(fitted.density) == pytest.approx(float(jfitted.density), abs=1e-6)


# -- the row-sharded training step -------------------------------------------------------


def _sharded(t, h, w, mesh, lr=1e-3):
    return tsh.train_step_sharded(_train(t["params"]), t["params"], t["config"], t["camera"],
                                  t["opaque"], t["target"], h, w, mesh, lr=lr)


def _dryrun_value_and_grad(j, h, w, n):
    """``dryrun_multichip``'s ``loss_fn`` on an ``n``-device mesh: each
    device's mean of its rows, the mean over devices."""
    mesh = jsh.make_mesh(jax.devices()[:n])
    axis = mesh.axis_names[0]
    row = P(axis, None)
    cam, params, config = j["camera"], j["params"], j["config"]
    ray_dir = jray_dirs(cam, h, w)
    jitter = jjitter(h, w)

    def loss_fn(train):
        p = dataclasses.replace(params, **train)
        body = jsh.shard_map(
            lambda a, rx, ry, rz, jt, tgt: jnp.mean(
                (jsh._shade_slice((a,), (config,), cam, j["opaque"], rx, ry, rz, jt)
                 - tgt) ** 2)[None],
            mesh=mesh, in_specs=(P(), row, row, row, row, P(axis, None, None)),
            out_specs=P(axis))
        return jnp.mean(body(p, ray_dir.x, ray_dir.y, ray_dir.z, jitter, j["target"]))

    return jax.jit(jax.value_and_grad(loss_fn))(_train(params))


def test_sharded_step_matches_the_jax_dryrun():
    h, w, lr = 16, 128, 1e-3
    j, t = _inputs("no_clouds", "exterior", h, w)
    jl, jg = _dryrun_value_and_grad(j, h, w, 2)
    mk.counters.reset()
    loss, grads = tsh.sharded_loss_and_gradients(_train(t["params"]), t["params"], t["config"],
                                                 t["camera"], t["opaque"], t["target"], h, w,
                                                 tsh.make_mesh(2))
    assert (mk.counters.plain_calls, mk.counters.megakernel_launches) == (2, 0)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _assert_grads_close(grads, jg, 1e-4, 1e-5)
    sl, new = _sharded(t, h, w, tsh.make_mesh(2), lr=lr)
    assert torch.equal(sl, loss)
    for k in KNOBS:
        np.testing.assert_allclose(new[k].numpy(), np.asarray(getattr(j["params"], k))
                                   - lr * np.asarray(jg[k]), rtol=1e-6, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("variant,pose,h,w", [("no_clouds", "exterior", 16, 128),
                                              ("clouds", "space", 32, 128)])
def test_sharded_step_equals_the_unsharded_step(variant, pose, h, w):
    """Two shards of the local mesh against one (the whole frame, which
    is the fitter's own loss, bit for bit): loss and gradients rtol 1e-5;
    the updated knobs finite."""
    _, t = _inputs(variant, pose, h, w)
    args = (_train(t["params"]), t["params"], t["config"], t["camera"], t["opaque"],
            t["target"], h, w)
    l1, g1 = tsh.sharded_loss_and_gradients(*args, tsh.make_mesh(1))
    l2, g2 = tsh.sharded_loss_and_gradients(*args, tsh.make_mesh(2))
    lf, gf = tinv.loss_and_gradients(_train(t["params"]), t["params"], t["config"], t["camera"],
                                     t["opaque"], t["target"], h, w)
    assert torch.equal(l1, lf) and all(torch.equal(g1[k], gf[k]) for k in KNOBS)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    for k in KNOBS:
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=1e-5, err_msg=k)
    _, new = _sharded(t, h, w, tsh.make_mesh(2))
    assert all(torch.isfinite(v).all() and not v.requires_grad for v in new.values())
    with pytest.raises(ValueError, match="not divisible"):
        tsh.train_step_sharded(*args, tsh.make_mesh(3))
