"""Port vs JAX: raymarched cloud lighting (``clouds.py::get_light_raymarched``
and the march that calls it, ``raymarch_cloud(raymarched_lighting=True)``).

Seeded model-space positions in the demo's cloud layer, a seeded sun
direction and seeded coverage values, with the demo's procedural shape
field (``clouds_high_rm``'s fast profile) on both sides: the sun march at
atol 1e-5, and the whole march at the cloud tolerance (p99.9 |Δ| ≤ 1e-3,
mean |Δ| ≤ 1e-4, at most 0.1 % of pixels above 1e-2: knife-edge noise cells
flip on ulp-level differences).

The sun march's outlier budget: a sample on the steep part of the density
ramp (``saturate(x·50 − 20)``) turns one f32 rounding of its height into
up to ~1.5e-4 of light; there a float64 evaluation of the same function
is as far from the port's f32 result as from JAX's (XLA contracts
multiply-adds, the port rounds each operation; checked below).  So at most
2 % of the samples may exceed atol 1e-5, none 3e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models.demo import build_demo_scene
from godot_atmosphere_shader_tpu.ops import clouds as jc
from godot_atmosphere_shader_tpu.render import atmosphere_pass as jpass
from godot_atmosphere_shader_tpu.utils.vecmath import Vec3 as JVec3
from godot_atmosphere_shader_tpu_torch.models.convert import (
    atmosphere_params_from_numpy, variant_config_from_fields)
from godot_atmosphere_shader_tpu_torch.ops import clouds as tc
from godot_atmosphere_shader_tpu_torch.render import atmosphere_pass as tpass
from godot_atmosphere_shader_tpu_torch.utils.vecmath import Vec3 as TVec3

torch.set_num_threads(1)

SHAPE = (16, 48)


def _fields(obj):
    return {f.name: None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def rm():
    scene = build_demo_scene("clouds_high_rm")
    atmo = scene.atmospheres[0]
    jp = atmo.build_params().resolve_frame_state()
    cfg = atmo.config
    assert cfg.raymarched_lighting and cfg.clouds_always_low_quality
    tp = atmosphere_params_from_numpy(_fields(jp), device="cpu")
    tcfg = variant_config_from_fields(dataclasses.asdict(cfg))
    return {"jp": jp, "tp": tp, "jcfg": cfg, "tcfg": tcfg,
            "tset": tc.cloud_settings(tp)}


def _jset(jp):
    return jc.CloudSettings(
        bottom_height=jp.planet_radius + jp.cloud_bottom * jp.atmosphere_height,
        top_height=jp.planet_radius + jp.cloud_top * jp.atmosphere_height,
        density_scale=jp.cloud_density_scale, ground_height=jp.planet_radius)


def _assert_sun_march_close(got, ref):
    d = np.abs(got.astype(np.float64) - ref)
    assert (d > 1e-5).mean() <= 0.02 and d.max() <= 3e-4, (float((d > 1e-5).mean()), d.max())


def _unit(rng, shape):
    v = rng.normal(size=(3,) + shape)
    return (v / np.linalg.norm(v, axis=0)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_get_light_raymarched_matches_jax(rm, seed):
    rng = np.random.default_rng(seed)
    jp, tp = rm["jp"], rm["tp"]
    radius = rng.uniform(101.4, 105.0, SHAPE)  # around the layer [101.6, 104.8]
    pos = (_unit(rng, SHAPE) * radius).astype(np.float32)
    sun = _unit(rng, ())
    cov = rng.uniform(0.3, 0.9, SHAPE).astype(np.float32)
    alpha0 = rng.random(SHAPE, dtype=np.float32)
    jshape = jpass.make_shape_fn(rm["jcfg"], jp)
    tshape = tpass.make_shape_fn(rm["tcfg"], tp)

    @jax.jit
    def jlight(pos, cov, alpha0):
        return jc.get_light_raymarched(JVec3(*pos), JVec3(*(float(v) for v in sun)), None,
                                       alpha0, jp.time, _jset(jp), jp, jshape, None, True,
                                       coverage_value=cov)

    ref = np.asarray(jlight(tuple(jnp.asarray(c) for c in pos), jnp.asarray(cov),
                            jnp.asarray(alpha0)))
    got = tc.get_light_raymarched(TVec3(*(torch.from_numpy(c) for c in pos)),
                                  TVec3(*(float(v) for v in sun)), None,
                                  torch.from_numpy(alpha0), tp.time, rm["tset"], tp, tshape, None,
                                  True, coverage_value=torch.from_numpy(cov)).numpy()
    _assert_sun_march_close(got, ref)
    # the sun march shades: lit (1) and shadowed (toward 0.2 · height ratio) samples
    assert got.min() < 0.5 and got.max() > 0.99


def test_get_light_raymarched_reuses_a_given_shape_value(rm):
    """Texture mode hands the march step's knot-interpolated shape value to
    every sun sample instead of evaluating a field."""
    rng = np.random.default_rng(5)
    jp, tp = rm["jp"], rm["tp"]
    pos = (_unit(rng, SHAPE) * rng.uniform(101.4, 105.0, SHAPE)).astype(np.float32)
    sun = _unit(rng, ())
    cov, shape = (rng.uniform(0.3, 0.9, SHAPE).astype(np.float32) for _ in range(2))
    zero = np.zeros(SHAPE, np.float32)
    ref = np.asarray(jc.get_light_raymarched(
        JVec3(*(jnp.asarray(c) for c in pos)), JVec3(*(float(v) for v in sun)), None,
        jnp.asarray(zero), jp.time, _jset(jp), jp, None, None, True,
        coverage_value=jnp.asarray(cov), shape_value=jnp.asarray(shape)))
    got = tc.get_light_raymarched(TVec3(*(torch.from_numpy(c) for c in pos)),
                                  TVec3(*(float(v) for v in sun)), None, torch.from_numpy(zero),
                                  tp.time, rm["tset"], tp, None, None, True,
                                  coverage_value=torch.from_numpy(cov),
                                  shape_value=torch.from_numpy(shape)).numpy()
    _assert_sun_march_close(got, ref)
    # the outliers are the function's own conditioning: evaluated in
    # float64, it is off both f32 results there by more than the atol
    tp64 = dataclasses.replace(tp, **{f.name: getattr(tp, f.name).double()
                                      for f in dataclasses.fields(tp)
                                      if isinstance(getattr(tp, f.name), torch.Tensor)})
    exact = tc.get_light_raymarched(TVec3(*(torch.from_numpy(c).double() for c in pos)),
                                    TVec3(*(float(v) for v in sun)), None,
                                    torch.from_numpy(zero).double(), tp64.time,
                                    tc.cloud_settings(tp64), tp64, None, None, True,
                                    coverage_value=torch.from_numpy(cov).double(),
                                    shape_value=torch.from_numpy(shape).double()).numpy()
    worst = np.abs(got.astype(np.float64) - ref).argmax()
    assert abs(got.flat[worst] - ref.flat[worst]) > 1e-5
    assert min(abs(exact.flat[worst] - got.flat[worst]),
               abs(exact.flat[worst] - ref.flat[worst])) > 1e-5


def test_raymarch_cloud_with_sun_march_matches_jax(rm):
    """The march with raymarched lighting over seeded rays from above the
    layer, with seeded coverage knots (the same on both sides)."""
    rng = np.random.default_rng(9)
    jp, tp = rm["jp"], rm["tp"]
    ro = np.array([0.0, 30.0, 150.0], np.float32)
    target = (_unit(rng, SHAPE) * 80.0).astype(np.float32)
    rd = target - ro[:, None, None]
    rd = (rd / np.linalg.norm(rd, axis=0)).astype(np.float32)
    top = float(jp.planet_radius + jp.cloud_top * jp.atmosphere_height)
    b = (ro[:, None, None] * rd).sum(0)
    h = top * top - ((ro[:, None, None] - rd * b) ** 2).sum(0)
    sq = np.sqrt(np.maximum(h, 0.0))
    tb = np.where(h > 0, np.maximum(-b - sq, 0.0), 0.0).astype(np.float32)
    te = np.where(h > 0, -b + sq, tb).astype(np.float32)
    jitter = rng.random(SHAPE, dtype=np.float32)
    knots = [rng.uniform(0.5, 0.9, SHAPE).astype(np.float32) for _ in range(9)]
    sun = _unit(rng, ())
    steps = 32
    jshape = jpass.make_shape_fn(rm["jcfg"], jp)
    tshape = tpass.make_shape_fn(rm["tcfg"], tp)

    @jax.jit
    def jmarch(rd, tb, te, jitter, knots):
        return jc.raymarch_cloud(JVec3(*(jnp.float32(v) for v in ro)), JVec3(*rd), tb, te,
                                 jitter, JVec3(*(float(v) for v in sun)), jp.time, _jset(jp), jp,
                                 jshape, None, steps, True, True, coverage_interp=True,
                                 coverage_endpoints=tuple(knots), knot_dynamic=True)

    jl, ja = jmarch(tuple(jnp.asarray(c) for c in rd), jnp.asarray(tb), jnp.asarray(te),
                    jnp.asarray(jitter), tuple(jnp.asarray(k) for k in knots))
    ref = np.stack([np.asarray(jl), np.asarray(ja)], -1)
    args = (TVec3(*(torch.tensor(float(v)) for v in ro)), TVec3(*(torch.from_numpy(c) for c in rd)),
            torch.from_numpy(tb), torch.from_numpy(te), torch.from_numpy(jitter),
            TVec3(*(float(v) for v in sun)), tp.time, rm["tset"], tp, tshape, None, steps)
    kw = dict(coverage_interp=True, coverage_endpoints=tuple(torch.from_numpy(k) for k in knots),
              knot_dynamic=True)
    tl, ta = tc.raymarch_cloud(*args, True, True, **kw)
    got = np.stack([tl.numpy(), ta.numpy()], -1)
    d = np.abs(got.astype(np.float64) - ref)
    assert np.percentile(d, 99.9) <= 1e-3 and d.mean() <= 1e-4
    assert (d.max(axis=-1) > 1e-2).mean() <= 1e-3
    assert ta.max() > 0.5  # clouds formed
    cheap, _ = tc.raymarch_cloud(*args, False, True, **kw)
    assert float((cheap - tl).abs().max()) > 1e-2  # the sun march changed the light


def test_detail_field_is_not_ported(rm):
    """The detail field is ported: at full quality each sun sample takes
    the full density (given detail knots' value) where the march's alpha is
    below 0.3 and the low one elsewhere, as JAX's d_full / d_low select."""
    rng = np.random.default_rng(13)
    jp, tp = rm["jp"], rm["tp"]
    pos = (_unit(rng, SHAPE) * rng.uniform(101.4, 105.0, SHAPE)).astype(np.float32)
    sun = _unit(rng, ())
    cov, shape, detail = (rng.uniform(0.3, 0.9, SHAPE).astype(np.float32) for _ in range(3))
    alpha0 = rng.random(SHAPE, dtype=np.float32)
    kw = dict(coverage_value=cov, shape_value=shape, detail_value=detail)
    ref = np.asarray(jc.get_light_raymarched(
        JVec3(*(jnp.asarray(c) for c in pos)), JVec3(*(float(v) for v in sun)), None,
        jnp.asarray(alpha0), jp.time, _jset(jp), jp, None, None, False,
        **{k: jnp.asarray(v) for k, v in kw.items()}))

    def port(always_low):
        return tc.get_light_raymarched(
            TVec3(*(torch.from_numpy(c) for c in pos)), TVec3(*(float(v) for v in sun)), None,
            torch.from_numpy(alpha0), tp.time, rm["tset"], tp, None, None, always_low,
            **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()

    got = port(False)
    _assert_sun_march_close(got, ref)
    low = port(True)
    changed = np.abs(got - low) > 1e-3
    assert changed.any() and (alpha0[changed] < 0.3).all()
