"""The optical-depth LUT: the port's bake, lookup and cache against the JAX
package's on the CPU.

The bake sums its 64 left-endpoint steps in the JAX bake's order: held to
atol 1e-6 × the LUT's maximum.  The bilinear lookup at texel centres
returns the texels; at seeded points it matches JAX at atol 1e-6.  A v2
frame with ``od_mode="lut"`` renders through the plain route and matches
the JAX XLA frame at atol 1e-5 with rtol 1e-4 (``tests/test_pallas.py``'s
bound for cloud-free frames).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models import demo as jdemo
from godot_atmosphere_shader_tpu.ops import optical_depth as jod
from godot_atmosphere_shader_tpu.utils import vecmath as jv
from godot_atmosphere_shader_tpu_torch.models import demo as tdemo
from godot_atmosphere_shader_tpu_torch.ops import optical_depth as tod
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from godot_atmosphere_shader_tpu_torch.utils import vecmath as tv

torch.set_num_threads(2)


@pytest.mark.parametrize("res,radius,height,density", [(32, 100.0, 8.0, 0.5),
                                                       (256, 100.0, 8.0, 0.5),
                                                       (32, 1.0, 0.2, 10.0)])
def test_bake_matches_jax(res, radius, height, density):
    ref = np.asarray(jod.bake_optical_depth(radius, height, density, resolution=res))
    got = tod.bake_optical_depth(radius, height, density, resolution=res, device="cpu")
    assert got.shape == (res, res) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6 * float(ref.max()))


def test_bilinear_clamp_at_texel_centres_and_between():
    rng = np.random.default_rng(3)
    tex = rng.random((16, 24), dtype=np.float32)
    t = torch.from_numpy(tex)
    v, u = np.meshgrid((np.arange(16) + 0.5) / 16, (np.arange(24) + 0.5) / 24, indexing="ij")
    got = tod.sample_bilinear_clamp(t, torch.tensor(u, dtype=torch.float32),
                                    torch.tensor(v, dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), tex)
    # between the centres and past the edges (clamped)
    u = rng.uniform(-0.2, 1.2, (40, 50)).astype(np.float32)
    v = rng.uniform(-0.2, 1.2, (40, 50)).astype(np.float32)
    ref = np.asarray(jod.sample_bilinear_clamp(jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v)))
    got = tod.sample_bilinear_clamp(t, torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def _rays(seed, n=(24, 32)):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3,) + n)
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    r = rng.uniform(96.0, 112.0, n)
    p = (rng.normal(size=(3,) + n))
    p = (p / np.linalg.norm(p, axis=0) * r).astype(np.float32)
    return p, d


def test_get_baked_optical_depth_and_reference_match_jax():
    lut_np = np.asarray(jod.bake_optical_depth(100.0, 8.0, 0.5, resolution=64))
    lut = torch.from_numpy(lut_np.copy())
    p, d = _rays(5)
    jp, jd = jv.Vec3(*map(jnp.asarray, p)), jv.Vec3(*map(jnp.asarray, d))
    tp, td = tv.Vec3(*map(torch.from_numpy, p)), tv.Vec3(*map(torch.from_numpy, d))
    zero_j, zero_t = jv.Vec3(0.0, 0.0, 0.0), tv.Vec3(0.0, 0.0, 0.0)
    ref = np.asarray(jod.get_baked_optical_depth(jp, jd, zero_j, jnp.asarray(lut_np), 100.0, 8.0))
    got = tod.get_baked_optical_depth(tp, td, zero_t, lut, 100.0, 8.0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    ref = np.asarray(jod.optical_depth_reference(jp, jd, zero_j, 100.0, 8.0, 0.5))
    got = tod.optical_depth_reference(tp, td, zero_t, 100.0, 8.0, 0.5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6 * float(ref.max()))


def test_cache_rebakes_on_change_only():
    cache = tod.OpticalDepthCache(resolution=16, device="cpu")
    a = cache.get(100.0, 8.0, 0.5)
    assert cache.get(100.0, 8.0, 0.5) is a and cache.bake_count == 1
    b = cache.get(100.0, 8.0, 0.6)  # density change: rebake
    assert cache.bake_count == 2 and not torch.equal(a, b)
    cache.get(101.0, 8.0, 0.5)
    cache.get(100.0, 9.0, 0.5)
    assert cache.bake_count == 4
    assert cache.get(100.0, 8.0, 0.5) is a and cache.bake_count == 4
    jcache = jod.OpticalDepthCache(resolution=16)
    np.testing.assert_allclose(a.numpy(), np.asarray(jcache.get(100.0, 8.0, 0.5)), rtol=0,
                               atol=1e-6 * float(a.max()))


def test_node_bakes_on_demand():
    """``build_params`` bakes the LUT once per radius, height and density
    (the ``u_density`` uniform rebakes), as the JAX node does."""
    scene = tdemo.build_demo_scene("no_clouds", device="cpu")
    atmo = scene.atmospheres[0]
    assert atmo.build_params().optical_depth_lut is None
    atmo.set_custom_shader(dataclasses.replace(atmo.config, od_mode="lut"))
    lut = atmo.build_params().optical_depth_lut
    assert lut.shape == (256, 256) and atmo._lut_cache.bake_count == 1
    assert atmo.build_params().optical_depth_lut is lut
    atmo.set_shader_parameter("u_density", 0.25)
    assert atmo.build_params().optical_depth_lut is not lut
    assert atmo._lut_cache.bake_count == 2


def test_lut_frame_matches_jax_xla():
    """``no_clouds`` with ``od_mode="lut"`` at the exterior pose, 32×48: the
    port's ``Scene.render`` (the plain route: the kernel's plan refuses the
    LUT) against the JAX ``Scene.render`` (its XLA path)."""
    h, w = 32, 48
    js = jdemo.build_demo_scene("no_clouds")
    ja = js.atmospheres[0]
    ja.set_custom_shader(dataclasses.replace(ja.config, od_mode="lut"))
    jc = jdemo.demo_camera("exterior")
    js.update(0.5, jc)
    ref = js.render(jc, h, w)
    ts = tdemo.build_demo_scene("no_clouds", device="cpu")
    ta = ts.atmospheres[0]
    ta.set_custom_shader(dataclasses.replace(ta.config, od_mode="lut"))
    tc = tdemo.demo_camera("exterior", device="cpu")
    ts.update(0.5, tc)
    mk.counters.reset()
    out = ts.render(tc, h, w)
    assert (mk.counters.plain_calls, mk.counters.megakernel_launches) == (1, 0)
    alpha = out["alpha"].numpy()
    assert alpha.max() > 0.05
    np.testing.assert_allclose(out["color"].numpy(), np.asarray(ref["color"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(alpha, np.asarray(ref["alpha"]), rtol=1e-4, atol=1e-5)
    # the LUT frame is not the analytic one (the route really samples the LUT)
    ta.set_custom_shader(dataclasses.replace(ta.config, od_mode="analytic"))
    analytic = ts.render(tc, h, w)["color"].numpy()
    assert np.abs(analytic - out["color"].numpy()).max() > 1e-4


def test_scene_carried_across_with_its_lut(monkeypatch):
    """A JAX scene carried across by ``models/convert.py``: a ``no_clouds``
    layer with ``od_mode="lut"`` and its baked LUT (kept, not baked again),
    an opaque scene of 12 spheres and 6 boxes, ``large_world=True``; its
    frame at 24×32 against the JAX XLA frame (run eagerly) at atol 1e-5,
    rtol 1e-4."""
    import jax

    from godot_atmosphere_shader_tpu.render.opaque import OpaqueScene as JOpaque
    from godot_atmosphere_shader_tpu_torch.models import convert

    rng = np.random.default_rng(12)
    spheres = [((float(x), float(y), float(z)), float(r), (0.5, 0.4, 0.3))
               for x, y, z, r in zip(*rng.uniform((-150, -60, 100, 2), (150, 60, 140, 8),
                                                  (12, 4)).T)]
    boxes = []
    for t in rng.uniform((-120, -50, 90), (120, 50, 130), (6, 3)):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = -t
        boxes.append((m, (3.0, 4.0, 5.0), (0.6, 0.6, 0.6)))
    js = jdemo.build_demo_scene("no_clouds")
    js.opaque = JOpaque.create(spheres=spheres, boxes=boxes, light_dir=(0.0, 0.0, -1.0),
                               sky_color=(0.001, 0.001, 0.002), star_intensity=1.0)
    js.large_world = True
    ja = js.atmospheres[0]
    ja.set_custom_shader(dataclasses.replace(ja.config, od_mode="lut"))
    jp = ja.build_params()

    def fields(obj):
        return {f.name: None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}

    node = {"planet_radius": ja.planet_radius, "atmosphere_height": ja.atmosphere_height,
            "transform": ja.transform, "sun_transform": ja.sun.transform, "name": ja.name,
            "clouds_rotation_speed": ja.clouds_rotation_speed,
            "force_fullscreen": ja.force_fullscreen}
    ts = convert.scene_from_numpy(
        [{"node": node, "config": dataclasses.asdict(ja.config), "params": fields(jp)}],
        fields(js.opaque), large_world=True, device="cpu")
    ta = ts.atmospheres[0]
    assert ts.large_world is True and ts.opaque.sphere_centers.shape == (12, 3)
    assert ts.opaque.box_world_to_box.shape == (6, 4, 4)
    assert ta.config.od_mode == "lut"
    np.testing.assert_array_equal(ta.build_params().optical_depth_lut.numpy(),
                                  np.asarray(jp.optical_depth_lut))
    assert ta._lut_cache.bake_count == 0
    h, w = 24, 32
    jc = jdemo.demo_camera("avatar")
    tc = tdemo.demo_camera("avatar", device="cpu")
    js.update(0.5, jc)
    ts.update(0.5, tc)

    def fori_loop(lower, upper, body, init, **kwargs):
        for i in range(int(lower), int(upper)):
            init = body(jnp.int32(i), init)
        return init

    monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)
    with jax.disable_jit():
        ref = js.render(jc, h, w, renderer="xla")
    out = ts.render(tc, h, w)
    assert ts._rebase_origin is not None
    for k in ("color", "alpha"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5)
