"""Card-only checks of the CUDA megakernel against its plain version.

Marked ``cuda``: on a machine without a CUDA device each test skips with a
reason.  This file imports only the port, so it runs wherever the port
does.  ``chip_smoke.py`` covers the same ground at full size.
"""

import dataclasses

import pytest
import torch

from godot_atmosphere_shader_tpu_torch.models.demo import build_demo_scene, demo_camera
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

H, W = 64, 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(variant, pose, device):
    scene = build_demo_scene(variant, device=device)
    cam = demo_camera(pose, device=device)
    scene.update(0.5, cam)
    _, params, configs = scene._sorted_layers(cam)
    return params[0], configs[0], cam, scene.opaque


def _image(out):
    return torch.cat([out["color"], out["alpha"][..., None]], dim=-1).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("variant,pose", [("no_clouds", "avatar"),
                                          ("clouds_high", "avatar"),
                                          ("clouds_high", "interior")])
def test_kernel_matches_plain(cuda, variant, pose):
    inputs = _inputs(variant, pose, cuda)
    mk.counters.reset()
    got = _image(mk.render_frame_megakernel(*inputs, H, W))
    ref = _image(mk.render_frame_plain(*inputs, H, W))
    assert (mk.counters.megakernel_launches, mk.counters.plain_calls) == (1, 1)
    assert torch.isfinite(got).all()
    d = (got.double() - ref.double()).abs()
    # cloud tolerance: knife-edge noise cells flip on ulp-level differences
    assert torch.quantile(d.flatten(), 0.999) <= 1e-3
    assert d.mean() <= 1e-4
    assert (d.amax(dim=-1) > 1e-2).double().mean() <= 1e-3


@pytest.mark.cuda
def test_scene_render_on_cuda_launches_the_kernel(cuda):
    scene = build_demo_scene("clouds_high", device=cuda)
    cam = demo_camera("avatar", device=cuda)
    scene.update(0.5, cam)
    mk.counters.reset()
    out = scene.render(cam, H, W)
    torch.cuda.synchronize()
    assert (mk.counters.megakernel_launches, mk.counters.plain_calls) == (1, 0)
    assert out["color"].device.type == "cuda" and set(out) == {"color", "alpha"}


@pytest.mark.cuda
def test_height_must_divide_the_row_group(cuda):
    params, config, cam, opaque = _inputs("clouds_high", "avatar", cuda)
    with pytest.raises(ValueError):
        mk.render_frame_megakernel(params, config, cam, opaque, H + 2, W)
    with pytest.raises(ValueError):
        mk.render_frame_megakernel(params, dataclasses.replace(config, od_mode="lut"),
                                   cam, opaque, H, W)
