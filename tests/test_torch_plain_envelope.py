"""The plain chain renders what the plain ops take, the kernel's envelope or not.

On the CPU ``Scene.render`` goes to the megakernel's plain version, which is
gated only by what the plain ops refuse (the kernel's ``check_config``
holds for CUDA tensors); a baked texture the pyramid builders refuse is
sampled exactly.  The card renders the first two cases (the general
instance) and refuses the third.  Each case against the JAX package's ``Scene.render`` on
the CPU (its XLA path), at the cloud tolerance (p99.9 |Δ| ≤ 1e-3, mean
|Δ| ≤ 1e-4, at most 0.1 % of pixels above 1e-2: knife-edge noise cells flip
on ulp-level differences):

* per-step coverage (``cloud_coverage_interp=False``, the reference
  shader's own path);
* hat-sum coverage knots (``knot_dynamic=False``, the ``VariantConfig``
  default);
* a 12³ shape texture (not a power of two in [8, 128]) beside a 32² cubemap,
  both seeded.
"""

import dataclasses

import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu.models import demo as jdemo
from godot_atmosphere_shader_tpu_torch.models import demo as tdemo
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

torch.set_num_threads(2)

H, W = 32, 64


def _image(out):
    return np.concatenate([np.asarray(out["color"]), np.asarray(out["alpha"])[..., None]], -1)


def _cloud_ok(got, ref):
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    return (np.percentile(d, 99.9) <= 1e-3 and d.mean() <= 1e-4
            and (d.max(axis=-1) > 1e-2).mean() <= 1e-3)


def _textures():
    rng = np.random.default_rng(12)
    return (rng.random((12, 12, 12)).astype(np.float32),
            rng.random((6, 32, 32)).astype(np.float32))


def _configure(atmo, demo, case):
    if case == "texture_12":
        atmo.set_custom_shader(demo.demo_variant("clouds", procedural=False))
        shape, cubemap = _textures()
        atmo.set_shader_parameter("u_cloud_shape_texture", shape)
        atmo.set_shader_parameter("u_cloud_coverage_cubemap", cubemap)
    else:
        change = dict(per_step_coverage=dict(cloud_coverage_interp=False),
                      hat_sum_knots=dict(knot_dynamic=False))[case]
        atmo.set_custom_shader(dataclasses.replace(atmo.config, **change))


@pytest.mark.parametrize("case", ["per_step_coverage", "hat_sum_knots", "texture_12"])
def test_scene_render_beyond_the_kernel_matches_jax(case):
    jscene = jdemo.build_demo_scene("clouds")
    scene = tdemo.build_demo_scene("clouds", device="cpu")
    _configure(jscene.atmospheres[0], jdemo, case)
    _configure(scene.atmospheres[0], tdemo, case)
    jcam, cam = jdemo.demo_camera("avatar"), tdemo.demo_camera("avatar", device="cpu")
    jscene.update(0.5, jcam)
    scene.update(0.5, cam)
    _, params, configs = scene._sorted_layers(cam)
    config, tex = scene._texture_plan(params[0], configs[0])
    if case == "texture_12":  # outside the kernel's envelope: the card refuses it
        with pytest.raises(ValueError):
            mk.check_config(config)
    else:  # the procedural instance renders it
        mk.check_config(config)
        assert not mk.texture_mode(config)
    assert tex is None  # no pyramids: the texture case is sampled exactly
    mk.counters.reset()
    got = _image({k: v.numpy() for k, v in scene.render(cam, H, W).items()})
    assert (mk.counters.plain_calls, mk.counters.megakernel_launches) == (1, 0)
    ref = _image(jscene.render(jcam, H, W))
    assert np.isfinite(got).all() and got[..., 3].max() > 0.05
    assert _cloud_ok(got, ref)
