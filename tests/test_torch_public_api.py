"""The public API: every name the JAX package exports, its quick start,
the node surface, and the external depth buffer of ``atmosphere_pass``,
against the JAX package on the CPU."""

import dataclasses
import inspect
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godot_atmosphere_shader_tpu as jpkg
import godot_atmosphere_shader_tpu_torch as tpkg
from godot_atmosphere_shader_tpu.models import demo as jdemo
from godot_atmosphere_shader_tpu.render import atmosphere_pass as jpass
from godot_atmosphere_shader_tpu.render.opaque import render_opaque as jopaque
from godot_atmosphere_shader_tpu.utils import camera as jcam
from godot_atmosphere_shader_tpu_torch.models import demo as tdemo
from godot_atmosphere_shader_tpu_torch.models.convert import (atmosphere_params_from_numpy,
                                                              camera_from_numpy)
from godot_atmosphere_shader_tpu_torch.render import atmosphere_pass as tpass
from godot_atmosphere_shader_tpu_torch.utils import camera as tcam

torch.set_num_threads(2)


def _fields(obj):
    return {f.name: None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def test_every_jax_export():
    """The JAX ``__all__`` and the port's are one set but for the glow
    stage, which the port exports beside it (``GlowSettings``,
    ``apply_glow``; the JAX package keeps them in ``render/glow.py``)."""
    assert set(tpkg.__all__) - {"GlowSettings", "apply_glow"} == set(jpkg.__all__)
    for name in tpkg.__all__:
        assert getattr(tpkg, name) is not None, name


def _quickstart(pkg, shader, **kw):
    """The package docstring's quick start, as written but for the
    variant, ``kw`` (the port's ``device="cpu"``) and a small frame."""
    sun = pkg.Node3D(position=(0, 0, 600))
    planet = pkg.PlanetAtmosphere(planet_radius=100.0, atmosphere_height=8.0, sun=sun,
                                  custom_shader=shader, **kw)
    planet.set_shader_parameter("u_density", 0.5)
    scene = pkg.Scene(atmospheres=[planet], **kw)
    cam = pkg.Camera.create(pkg.look_at((0, 150, 420), (0, 0, 0), **kw), **kw)
    scene.update(time_s=0.0, camera=cam)
    return scene.render(cam, 24, 32)


def test_quickstart_on_the_cpu(monkeypatch):
    """As written (``"clouds"`` without a cloud texture or procedural
    spec) both packages refuse the frame with the same ``ValueError``; with
    ``"no_clouds"`` the port renders JAX's frame (run eagerly) at atol
    1e-5, rtol 1e-4.  The card is every entry point's default."""
    import jax

    with pytest.raises(ValueError, match="clouds need cloud_shape_texture"):
        _quickstart(tpkg, "clouds", device="cpu")
    with jax.disable_jit(), pytest.raises(ValueError, match="clouds need cloud_shape_texture"):
        _quickstart(jpkg, "clouds")
    got = _quickstart(tpkg, "no_clouds", device="cpu")

    def fori_loop(lower, upper, body, init, **kwargs):
        for i in range(int(lower), int(upper)):
            init = body(jnp.int32(i), init)
        return init

    monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)
    with jax.disable_jit():
        ref = _quickstart(jpkg, "no_clouds")
    assert got["color"].shape == (24, 32, 3) and float(got["alpha"].max()) > 0.05
    for k in ("color", "alpha"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5)
    for fn in (tpkg.Camera.create, tpkg.look_at, tpkg.Scene, tpkg.PlanetAtmosphere):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_node_surface_equals_jax():
    ja = jpkg.PlanetAtmosphere(planet_radius=100.0, atmosphere_height=8.0,
                               custom_shader="clouds")
    ta = tpkg.PlanetAtmosphere(planet_radius=100.0, atmosphere_height=8.0,
                               custom_shader="clouds", device="cpu")
    assert ta.get_property_list() == ja.get_property_list()
    assert ta.get_configuration_warnings() == ja.get_configuration_warnings()
    ta.sun, ja.sun = object(), object()
    assert ta.get_configuration_warnings() == ja.get_configuration_warnings()
    ta.sun, ja.sun = tpkg.Node3D(), jpkg.Node3D()
    assert ta.get_configuration_warnings() == ja.get_configuration_warnings() == []
    assert dataclasses.asdict(ta.custom_shader) == dataclasses.asdict(ja.custom_shader)
    for pkg_atmo in (ta, ja):
        with pytest.warns(DeprecationWarning):
            pkg_atmo.set_shader_param("u_density", 0.3)
        with pytest.warns(DeprecationWarning):
            assert float(pkg_atmo.get_shader_param("u_density")) == pytest.approx(0.3)
    # update(camera=), update(cam_pos=, origin=) and update() with neither
    cam = tpkg.Camera.create(tpkg.look_at((0, 150, 420), (0, 0, 0), device="cpu"),
                             device="cpu")
    jc = jpkg.Camera.create(jpkg.look_at((0, 150, 420), (0, 0, 0)))
    for kw_t, kw_j in ((dict(camera=cam), dict(camera=jc)),
                       (dict(cam_pos=np.array([0.0, 0.0, 105.0]), origin=np.ones(3)),
                        dict(cam_pos=np.array([0.0, 0.0, 105.0]), origin=np.ones(3))),
                       ({}, {})):
        ta.update(0.25, **kw_t)
        ja.update(0.25, **kw_j)
        assert (ta.mode, ta._interior_lod_active) == (ja.mode, ja._interior_lod_active)
        np.testing.assert_allclose(ta._params.frame_state.numpy(),
                                   np.asarray(ja._params.frame_state), rtol=1e-6, atol=1e-6)
    scene = tdemo.default_node_scene(device="cpu")
    jscene = jdemo.default_node_scene()
    assert float(scene.atmospheres[0].get_shader_parameter("u_density")) == 10.0
    assert dataclasses.asdict(scene.atmospheres[0].config) == dataclasses.asdict(
        jscene.atmospheres[0].config)


def test_atmosphere_pass_with_external_depth_buffer():
    """A nonlinear reverse-Z depth buffer (the JAX opaque pass's) through
    ``atmosphere_pass(depth=)``: ``linear_depth_from_buffer``, then the
    layer, against JAX at atol 1e-5, rtol 1e-4 (cloud-free)."""
    h, w = 24, 32
    scene = jdemo.build_demo_scene("no_clouds")
    cam = jdemo.demo_camera("exterior")
    scene.update(0.5, cam)
    jp = scene.atmospheres[0].build_params().resolve_frame_state()
    cfg = scene.atmospheres[0].config
    _, depth, lin = jopaque(scene.opaque, cam, h, w)
    depth = np.array(depth)
    tc = camera_from_numpy(_fields(cam), device="cpu")
    tp = atmosphere_params_from_numpy(_fields(jp), device="cpu")
    np.testing.assert_allclose(
        tcam.linear_depth_from_buffer(tc, torch.from_numpy(depth), h, w).numpy(),
        np.asarray(jcam.linear_depth_from_buffer(cam, jnp.asarray(depth), h, w)),
        rtol=1e-5)
    np.testing.assert_allclose(tcam.projection_matrix(tc, w / h).numpy(),
                               np.asarray(jcam.projection_matrix(cam, w / h)), rtol=1e-6)
    jitter = np.random.default_rng(4).random((h, w), dtype=np.float32)
    jrgb, ja, jhit = jpass.atmosphere_pass(jp, cfg, cam, h, w, depth=jnp.asarray(depth),
                                           jitter=jnp.asarray(jitter))
    tcfg = tpkg.VARIANTS["no_clouds"]
    trgb, ta, thit = tpass.atmosphere_pass(tp, tcfg, tc, h, w, depth=torch.from_numpy(depth),
                                           jitter=torch.from_numpy(jitter))
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    assert np.asarray(jhit).any() and (np.asarray(lin) < 1e7).any()
    for j, t in zip(list(jrgb) + [ja], list(trgb) + [ta]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-5)
