"""K1's procedural envelope on the CPU: every procedural cloud config that
the JAX megakernel renders, through the port's ``Scene.render`` (its plain
chain on CPU tensors) against the JAX package's ``Scene.render`` (its XLA
path, run eagerly: compiling each config's frame costs 30–250 s, evaluating
its operations one by one 3–25 s) at 32×64 with 8 march steps.

Tolerances: the cloud tolerance (p99.9 |Δ| ≤ 1e-3, mean |Δ| ≤ 1e-4, at
most 0.1 % of pixels above 1e-2: knife-edge noise cells flip on ulp-level
differences); at full quality the detail tolerance, p99 in place of p99.9:
the detail field samples the shape field at pos·15, so one ulp of a march
position moves a cloud pixel by ~1e-3 (``test_detail_field_is_ill_
conditioned``: the port against itself with the camera one ulp away).
For each config the kernel's ``check_config`` accepts it (the card renders
it).  This file holds the full-quality frames and the launch structs;
``test_torch_envelope_cellular.py`` the cellular tier and the ``.tscn``
importer's profile; ``test_torch_envelope_fields.py`` the other bases, the
ping-pong fractal and the knot and LOD settings.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models import demo as jdemo
from godot_atmosphere_shader_tpu.models import params as jparams
from godot_atmosphere_shader_tpu.ops import noise as jnoise
from godot_atmosphere_shader_tpu_torch.models import convert
from godot_atmosphere_shader_tpu_torch.models import demo as tdemo
from godot_atmosphere_shader_tpu_torch.models import params as tparams
from godot_atmosphere_shader_tpu_torch.ops import noise as tnoise
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

torch.set_num_threads(2)

H, W = 32, 64


STEPS = 8


@pytest.fixture
def eager_jax(monkeypatch):
    """The JAX package's XLA path run op by op: ``jax.disable_jit`` with a
    ``fori_loop`` that hands its body an int32 index, as the traced loop
    does (the eager one hands a Python int)."""
    def fori_loop(lower, upper, body, init, **kwargs):
        val = init
        for i in range(int(lower), int(upper)):
            val = body(jnp.int32(i), val)
        return val

    monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)
    with jax.disable_jit():
        yield


def _image(out):
    return np.concatenate([np.asarray(out["color"]), np.asarray(out["alpha"])[..., None]], -1)


def _cloud_ok(got, ref, quantile=99.9):
    """The cloud tolerance; ``quantile=99`` is the detail tolerance."""
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    return (np.percentile(d, quantile) <= 1e-3 and d.mean() <= 1e-4
            and (d.max(axis=-1) > 1e-2).mean() <= 1e-3)


def _coverage(pkg, **kw):
    """The demo's coverage field with its noise spec changed."""
    noise = dataclasses.replace(pkg["demo"].COVERAGE_NOISE, **kw)
    return pkg["params"].ProceduralField(noise=noise, scale=pkg["demo"].COVERAGE_SCALE)


def _tscn_profile(pkg):
    """What ``models/tscn.py:503-512`` builds from the reference demo: the
    ``clouds`` variant with the baked shape's spec and the cubemap's spec
    in the march, coverage knots (K = 8, hat sum), LOD 1."""
    p, d = pkg["params"], pkg["demo"]
    return dataclasses.replace(
        p.VARIANTS["clouds"],
        cloud_shape_noise=p.ProceduralField(noise=d.SHAPE_NOISE_BAKE,
                                            scale=(float(d.SHAPE_TEXTURE_SIZE),) * 3),
        cloud_coverage_noise=p.ProceduralField(noise=d.COVERAGE_NOISE, scale=d.COVERAGE_SCALE),
        cloud_coverage_interp=True)


# case: (variant, shape_basis, config changes given the package, pose); None:
# the .tscn importer's profile
CASES = {
    "detail_per_step": ("clouds", "value", lambda pkg: dict(clouds_always_low_quality=False),
                        "avatar"),
    "detail_per_step_raymarched": ("clouds_high_rm", "value",
                                   lambda pkg: dict(clouds_always_low_quality=False), "avatar"),
    "detail_knots": ("clouds", "value", lambda pkg: dict(clouds_always_low_quality=False,
                                                         cloud_shape_interp=True,
                                                         cloud_shape_knots=8), "avatar"),
}
CELLULAR_CASES = {
    "cellular_tier": ("clouds", "cellular", lambda pkg: {}, "avatar"),
    "tscn_profile": ("clouds", "value", None, "avatar"),
}
FIELD_CASES = {
    "perlin_coverage": ("clouds", "value",
                        lambda pkg: dict(cloud_coverage_noise=_coverage(pkg, noise_type="perlin")),
                        "avatar"),
    "simplex_coverage": ("clouds", "value",
                         lambda pkg: dict(cloud_coverage_noise=_coverage(pkg, noise_type="simplex")),
                         "avatar"),
    "ping_pong_coverage": ("clouds", "value", lambda pkg: dict(cloud_coverage_noise=_coverage(
        pkg, fractal_type="ping_pong", weighted_strength=0.5)), "avatar"),
    "coverage_k4": ("clouds", "value", lambda pkg: dict(cloud_coverage_knots=4), "avatar"),
    "coverage_k16": ("clouds", "value", lambda pkg: dict(cloud_coverage_knots=16,
                                                         knot_dynamic=False), "avatar"),
    "shape_k8": ("clouds", "value", lambda pkg: dict(cloud_shape_interp=True, cloud_shape_knots=8),
                 "avatar"),
    "group_16": ("clouds", "value", lambda pkg: dict(cloud_lod=8, cloud_coverage_lod=2),
                 "avatar"),
}
ALL_CASES = {**CASES, **CELLULAR_CASES, **FIELD_CASES}

JAX = {"demo": jdemo, "params": jparams, "noise": jnoise}
PORT = {"demo": tdemo, "params": tparams, "noise": tnoise}


def _config(pkg, case):
    variant, basis, change, _ = ALL_CASES[case]
    if change is None:
        return dataclasses.replace(_tscn_profile(pkg), cloud_steps=STEPS)
    base = pkg["demo"].demo_variant(variant, shape_basis=basis)
    return dataclasses.replace(base, cloud_steps=STEPS, **change(pkg))


def _scenes(case):
    variant, basis, _, pose = ALL_CASES[case]
    jscene = jdemo.build_demo_scene(variant, shape_basis=basis)
    scene = tdemo.build_demo_scene(variant, shape_basis=basis, device="cpu")
    jscene.atmospheres[0].set_custom_shader(_config(JAX, case))
    scene.atmospheres[0].set_custom_shader(_config(PORT, case))
    jcam, cam = jdemo.demo_camera(pose), tdemo.demo_camera(pose, device="cpu")
    jscene.update(0.5, jcam)
    scene.update(0.5, cam)
    return jscene, jcam, scene, cam


def check_case(case):
    """``Scene.render`` of the port against JAX's for one case (call under
    :func:`eager_jax`)."""
    jscene, jcam, scene, cam = _scenes(case)
    _, params, configs = scene._sorted_layers(cam)
    mk.check_config(configs[0])  # inside the kernel's envelope: the card renders it
    mk.counters.reset()
    got = _image({k: v.numpy() for k, v in scene.render(cam, H, W).items()})
    assert (mk.counters.plain_calls, mk.counters.megakernel_launches) == (1, 0)
    ref = _image(jscene.render(jcam, H, W))
    assert np.isfinite(got).all() and got[..., 3].max() > 0.05
    assert _cloud_ok(got, ref, 99.9 if configs[0].clouds_always_low_quality else 99)


@pytest.mark.parametrize("case", list(CASES))
def test_scene_render_matches_jax(case, eager_jax):
    check_case(case)


def test_detail_field_is_ill_conditioned():
    """Why full quality has its own tolerance: moving the camera one ulp
    along z moves a full-quality frame by more than the cloud tolerance's
    p99.9 (the detail field samples the shape at pos·15), a low-quality
    frame by far less."""
    stats = {}
    for low in (True, False):
        scene = tdemo.build_demo_scene("clouds", device="cpu")
        atmo = scene.atmospheres[0]
        atmo.set_custom_shader(dataclasses.replace(atmo.config, clouds_always_low_quality=low))
        frames = []
        for nudge in (False, True):
            cam = tdemo.demo_camera("avatar", device="cpu")
            if nudge:
                v2w = cam.view_to_world.clone()
                v2w[2, 3] = torch.nextafter(v2w[2, 3], torch.tensor(1e9))
                cam = dataclasses.replace(cam, view_to_world=v2w)
            scene.update(0.5, cam)
            frames.append(_image({k: v.numpy() for k, v in scene.render(cam, H, W).items()}))
        d = np.abs(frames[0].astype(np.float64) - frames[1])
        stats[low] = (np.percentile(d, 99.9), np.percentile(d, 99))
    assert stats[True][0] < 2e-4 and stats[False][0] > 1e-3
    assert stats[False][1] <= 1e-3  # the detail tolerance holds


def test_launch_structs_carry_the_envelope():
    """What ``frame_constants`` sets for the kernel: the noise codes, the
    ping-pong and weighted strengths, the cellular settings, the detail
    term (0 at full quality), the time, the knot counts and flags."""
    scene = tdemo.build_demo_scene("clouds", device="cpu")
    cam = tdemo.demo_camera("avatar", device="cpu")
    scene.update(0.75, cam)
    _, params, configs = scene._sorted_layers(cam)

    def struct(case):
        cfg = _config(PORT, case)
        mk.check_config(cfg)
        return mk.frame_constants(params[0], cfg, cam, scene.opaque, H, W)

    demo = mk.frame_constants(params[0], configs[0], cam, scene.opaque, H, W)
    assert (demo.coverage_interp, demo.shape_interp, demo.always_low) == (1, 0, 1)
    assert demo.cloud_detail_term == pytest.approx(0.1)
    time = float(params[0].resolve_frame_state().time)
    assert time > 0.0 and demo.time == pytest.approx(time)
    s = struct("detail_knots")
    assert (s.always_low, s.shape_interp, s.shape_knots) == (0, 1, 8)
    assert s.cloud_detail_term == 0.0 and s.time == pytest.approx(time)
    s = struct("tscn_profile")
    assert (s.shape.noise_type, s.shape.fractal_type, s.shape.octaves) == (
        mk.NOISE_TYPES["cellular"], mk.FRACTAL_TYPES["ridged"], 8)
    assert (s.shape.cellular_return, s.shape.cellular_jitter) == (
        mk.CELLULAR_RETURNS["distance"], 1.0)
    assert (s.coverage_knots, s.cloud_lod, s.coverage_lod) == (8, 1, 1)
    s = struct("ping_pong_coverage")
    assert s.coverage.fractal_type == mk.FRACTAL_TYPES["ping_pong"]
    assert (s.coverage.ping_pong_strength, s.coverage.weighted_strength) == (2.0, 0.5)
    assert s.coverage.gain == 0.5
    s = struct("cellular_tier")
    assert s.shape.noise_type == mk.NOISE_TYPES["cellular_fast"]
    assert struct("perlin_coverage").coverage.noise_type == mk.NOISE_TYPES["perlin"]
    assert struct("simplex_coverage").coverage.noise_type == mk.NOISE_TYPES["simplex"]
    assert struct("coverage_k16").coverage_knots == 16
    s = struct("group_16")
    assert s.cloud_lod * s.coverage_lod == 16
    s = mk.frame_constants(params[0], dataclasses.replace(configs[0], cloud_coverage_interp=False),
                           cam, scene.opaque, H, W)
    assert s.coverage_interp == 0


@pytest.mark.parametrize("case", list(ALL_CASES) + ["cellular_demo_variant"])
def test_configs_convert_from_jax(case):
    """``variant_config_from_fields`` of each JAX config of the envelope
    (the cellular tier's SHAPE_NOISE_FAST_CELL, ping-pong and weighted
    specs, full quality, knots) equals the port's own config."""
    if case == "cellular_demo_variant":
        jcfg, tcfg = (pkg.demo_variant("clouds_high", shape_basis="cellular")
                      for pkg in (jdemo, tdemo))
    else:
        jcfg, tcfg = _config(JAX, case), _config(PORT, case)
    assert convert.variant_config_from_fields(dataclasses.asdict(jcfg)) == tcfg
