"""K1's procedural envelope on the CPU: procedural shape knots over a
coverage group of 32 rows (cloud_lod 1 with coverage_lod 32 and 16 shape
knots; cloud_lod 2 with coverage_lod 16 and 100 shape knots), at 64×128 so
that a column holds two coverage groups, with clouds_high's 64 march steps.

The port's ``Scene.render`` (its plain chain) against the JAX package's
(its XLA path run eagerly, ``test_torch_envelope.py``'s ``eager_jax``).
Both reduce a group's mean ray and span in row order (JAX's CPU ``mean``
sums its rows in order, then divides), so neither side is at fault: the
frames differ because the configs are ill-conditioned.  A group's shape
knots lie along its mean march span, up to ~1e5 units long; one ulp of one
pixel's span moves a knot's shape value, and the knot's column of 32
pixels with it.  ``test_knot_groups_are_ill_conditioned`` shows it: the
port against itself with every span one ulp longer leaves the cloud
tolerance at these configs and keeps it at the demo profile (4-row groups)
and without shape knots.  Both comparisons are held to the knot-group
tolerance of ``chip_smoke.py`` (``knot_group_tolerance_ok``): p99 ≤ 1e-3
for p99.9, mean ≤ 1e-4, at most 0.5 % of pixels above 1e-2 (one flipped
knot moves 0.39 % of the frame).
"""

import dataclasses

import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models import demo as jdemo
from godot_atmosphere_shader_tpu_torch.models import demo as tdemo
from godot_atmosphere_shader_tpu_torch.ops import clouds as tclouds
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from test_torch_envelope import _cloud_ok, _image, eager_jax  # noqa: F401

torch.set_num_threads(2)

H, W = 64, 128

# case: (cloud_lod, cloud_coverage_lod, shape knots or 0 for none)
KNOT_GROUPS = {"coverage_lod_32_shape_knots_16": (1, 32, 16),
               "coverage_lod_16_shape_knots_100": (2, 16, 100)}
CONTROLS = {"shape_knots_16": (2, 2, 16), "coverage_lod_32": (1, 32, 0)}


def _knot_group_ok(got, ref):
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    return (np.percentile(d, 99) <= 1e-3 and d.mean() <= 1e-4
            and (d.max(axis=-1) > 1e-2).mean() <= 5e-3)


def _config(pkg, lod, coverage_lod, shape_knots):
    change = dict(cloud_lod=lod, cloud_coverage_lod=coverage_lod, cloud_lod_interior=0)
    if shape_knots:
        change.update(cloud_shape_interp=True, cloud_shape_knots=shape_knots)
    return dataclasses.replace(pkg.demo_variant("clouds_high"), **change)


def _port_frame(case):
    scene = tdemo.build_demo_scene("clouds_high", device="cpu")
    scene.atmospheres[0].set_custom_shader(_config(tdemo, *case))
    cam = tdemo.demo_camera("avatar", device="cpu")
    scene.update(0.5, cam)
    _, _, configs = scene._sorted_layers(cam)
    mk.check_config(configs[0])  # the card renders it too
    return _image({k: v.numpy() for k, v in scene.render(cam, H, W).items()})


@pytest.fixture
def longer_spans(monkeypatch):
    """Every coarse pixel's march span one ulp past its clamped end."""
    clamp = tclouds.clamp_march_distance

    def longer(*args):
        t_end = clamp(*args)
        return torch.nextafter(t_end, torch.full_like(t_end, float("inf")))

    return lambda: monkeypatch.setattr(tclouds, "clamp_march_distance", longer)


@pytest.mark.parametrize("case", list(KNOT_GROUPS))
def test_knot_group_frame_matches_jax(case, eager_jax):  # noqa: F811
    jscene = jdemo.build_demo_scene("clouds_high")
    jscene.atmospheres[0].set_custom_shader(_config(jdemo, *KNOT_GROUPS[case]))
    jcam = jdemo.demo_camera("avatar")
    jscene.update(0.5, jcam)
    ref = _image(jscene.render(jcam, H, W))
    got = _port_frame(KNOT_GROUPS[case])
    assert np.isfinite(got).all() and got[..., 3].max() > 0.05
    assert _knot_group_ok(got, ref)


def test_knot_groups_are_ill_conditioned(longer_spans):
    """One ulp of every march span moves the knot-group frames beyond the
    cloud tolerance, and keeps them within the knot-group tolerance; the
    demo profile's 4-row groups with shape knots, and 32-row groups with
    coverage knots alone, stay within the cloud tolerance."""
    cases = {**KNOT_GROUPS, **CONTROLS}
    frames = {name: _port_frame(case) for name, case in cases.items()}
    longer_spans()
    for name, case in cases.items():
        moved = _port_frame(case)
        assert _knot_group_ok(moved, frames[name]), name
        assert _cloud_ok(moved, frames[name]) == (name in CONTROLS), name
