"""Card-only checks of the CUDA megakernel against its plain version.

Marked ``cuda``: on a machine without a CUDA device each test skips with a
reason.  This file imports only the port, so it runs wherever the port
does.  ``chip_smoke.py`` covers the same ground at full size.
"""

import dataclasses

import pytest
import torch

from godot_atmosphere_shader_tpu_torch.models.demo import (bake_demo_textures,
                                                           build_demo_scene, demo_camera)
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from godot_atmosphere_shader_tpu_torch.ops.kernels import texsample as ts

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


# -- texture mode (K2 inside K1) --------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tex3d", "latlong"])
def test_k2_alone_matches_plain(cuda, kind):
    """K2's device functions on caller-given batches against the plain
    samplers on the same CUDA inputs: same mode and level per batch, values
    at atol 2e-6."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    if kind == "tex3d":
        data, meta = ts.build_tex3d_pyramid(torch.rand((64,) * 3, generator=gen).numpy())
    else:
        data, meta = ts.build_latlong_pyramid(torch.rand((6, 64, 64), generator=gen).numpy())
    table = torch.as_tensor(data, device=cuda)
    lo = torch.rand((3, 16, 1), generator=gen)
    ext = torch.tensor([0.01, 0.05, 0.3, 1.0]).repeat(4)[:, None]
    planes = [(lo[a] + ext * torch.rand((16, 1024), generator=gen)).to(cuda) for a in range(3)]
    if kind == "latlong":
        planes = [p - 0.5 for p in planes]
        n = torch.sqrt(sum(p * p for p in planes))
        planes = [p / n for p in planes]
    mk.counters.reset()
    got = mk.sample_batches(table, meta, *planes)
    ref = mk.sample_batches(table.cpu(), meta, *(p.cpu() for p in planes))
    assert mk.counters.texsample_launches == 1
    assert torch.equal(got[1].cpu(), ref[1]) and torch.equal(got[2].cpu(), ref[2])
    assert len(set(ref[1].tolist())) > 1  # more than one mode among the batches
    assert (got[0].cpu() - ref[0]).abs().max() <= 2e-6


@pytest.fixture(scope="module")
def baked():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return bake_demo_textures(device=torch.device("cuda", 0))


@pytest.mark.cuda
@pytest.mark.parametrize("pose", ["avatar", "interior"])
def test_texture_kernel_matches_plain(cuda, baked, pose):
    scene = build_demo_scene("clouds_high", procedural=False, device=cuda, textures=baked)
    cam = demo_camera(pose, device=cuda)
    scene.update(0.5, cam)
    _, params, configs = scene._sorted_layers(cam)
    config, tex = scene._texture_plan(params[0], configs[0])
    mk.counters.reset()
    got = _image(mk.render_frame_megakernel(params[0], config, cam, scene.opaque, H, W,
                                            tex_data=tex))
    ref = _image(mk.render_frame_plain(params[0], config, cam, scene.opaque, H, W,
                                       tex_data=tex))
    assert (mk.counters.texture_launches, mk.counters.plain_calls) == (1, 1)
    assert torch.isfinite(got).all()
    d = (got.double() - ref.double()).abs()
    assert torch.quantile(d.flatten(), 0.999) <= 1e-3
    assert d.mean() <= 1e-4
    assert (d.amax(dim=-1) > 1e-2).double().mean() <= 1e-3
