"""Card-only checks of the CUDA kernels against their plain versions.

Marked ``cuda``: on a machine without a CUDA device each test skips with a
reason.  This file imports only the port (and, inside the texture
envelope's tests, ``chip_smoke.py``'s scene helpers), so it runs wherever
the port does.  ``chip_smoke.py`` covers the same ground at full size.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from godot_atmosphere_shader_tpu_torch.models.demo import (bake_demo_textures,
                                                           build_demo_scene, demo_camera)
from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
from godot_atmosphere_shader_tpu_torch.ops.kernels import texsample as ts
from godot_atmosphere_shader_tpu_torch.tools import gpu_checks
from godot_atmosphere_shader_tpu_torch.tools import measure_band_fidelity as bf

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
@pytest.mark.parametrize("lods", [(2, 2), (8, 2)])
def test_height_need_not_divide_the_row_group(cuda, lods):
    """A partial last LOD group is rendered whole, rows past the frame
    computed and not stored (the plain renderer pads the same way); the LUT
    still raises."""
    params, config, cam, opaque = _inputs("clouds_high", "avatar", cuda)
    config = dataclasses.replace(config, cloud_lod=lods[0], cloud_coverage_lod=lods[1])
    got = _image(mk.render_frame_megakernel(params, config, cam, opaque, H + 2, W))
    ref = _image(mk.render_frame_plain(params, config, cam, opaque, H + 2, W))
    assert got.shape == (H + 2, W, 4) and _cloud_ok(got, ref)
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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tex3d", "latlong"])
@pytest.mark.parametrize("n", [1, 1023, 8192, 8193, 20000])
@pytest.mark.parametrize("offset", [0, 1])
def test_k2_alone_any_batch_length_and_alignment(cuda, kind, n, offset):
    """Every path of ``texsample_kernel``: 16-byte loads (n % 4 == 0 on
    aligned planes) or 4-byte ones (any other n, or planes one float off
    16-byte alignment), a batch kept on chip (n ≤ TEXSAMPLE_KEEP) or read
    twice, against the plain samplers on the same CUDA inputs: the same
    mode and level in every batch, values at atol 2e-6, one launch."""
    gen = torch.Generator(device="cpu").manual_seed(n + offset)
    if kind == "tex3d":
        data, meta = ts.build_tex3d_pyramid(torch.rand((64,) * 3, generator=gen).numpy())
    else:
        data, meta = ts.build_latlong_pyramid(torch.rand((6, 64, 64), generator=gen).numpy())
    table = torch.as_tensor(data, device=cuda)
    b = 8
    lo = torch.rand((3, b, 1), generator=gen)
    ext = torch.tensor([0.01, 0.05, 0.3, 1.0]).repeat(2)[:, None]
    planes = [lo[a] + ext * torch.rand((b, n), generator=gen) for a in range(3)]
    if kind == "latlong":
        planes = [p - 0.5 for p in planes]
        norm = torch.sqrt(sum(p * p for p in planes))
        planes = [p / norm for p in planes]
    flats = [torch.empty(b * n + offset, device=cuda) for _ in range(3)]
    for f, p in zip(flats, planes):
        f[offset:].copy_(p.reshape(-1))
    views = [f[offset:].view(b, n) for f in flats]
    aligned = not any(v.data_ptr() % 16 for v in views)
    plan = mk.texsample_plan(b, n, aligned, kind == "tex3d")
    assert plan["vector"] == (offset == 0 and n % 4 == 0)
    mk.counters.reset()
    got = mk.sample_batches(table, meta, *views)
    ref = mk.sample_batches(table.cpu(), meta, *planes)
    assert mk.counters.texsample_launches == 1
    assert torch.equal(got[1].cpu(), ref[1]) and torch.equal(got[2].cpu(), ref[2])
    assert (got[0].cpu() - ref[0]).abs().max() <= 2e-6


@pytest.fixture(scope="module")
def baked():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return bake_demo_textures(device=torch.device("cuda", 0))


def _texture_scene(device, baked, pose, group, sky=False):
    """``clouds_high`` in texture mode with G = cloud_lod·coverage_lod rows
    per thread (the demo's 2·2 at avatar, 4·2 at interior), optionally
    with a panorama, updated."""
    scene = build_demo_scene("clouds_high", procedural=False, device=device, textures=baked)
    if sky:
        _with_panorama(scene, device)
    cam = demo_camera(pose, device=device)
    if group != (4 if pose == "avatar" else 8):
        atmo = scene.atmospheres[0]
        atmo.set_custom_shader(dataclasses.replace(atmo.config, cloud_lod=group // 2,
                                                   cloud_lod_interior=0))
    scene.update(0.5, cam)
    return scene, cam


@pytest.mark.cuda
@pytest.mark.parametrize("pose,group,mode", [
    ("avatar", 4, "fused"), ("interior", 8, "fused"), ("avatar", 8, "fused"),
    ("avatar", 4, "chained"), ("avatar", 8, "chained"), ("avatar", 4, "sky"),
    ("avatar", 8, "sky")])
def test_texture_kernel_matches_plain(cuda, baked, pose, group, mode):
    """The texture instance (``megakernel_tex<G>``, G = 4 and 8) against the
    plain version on the same CUDA inputs, at the cloud tolerance: a fused
    layer (and what its instance uses: the wrapper's threads and shared
    memory, TEX_SM_THREADS resident threads per SM); the layer chained over
    a far moon on a 256-row shard (rows 256-511 of a 512×128 frame, through
    the band entries); a fused layer that draws the panorama sky (its
    choice made in the tile's block)."""
    if mode == "chained":
        scene, cam, params, configs, tex, pdata, pmeta = _shard_scene(cuda, baked)
        layer = [mk.texture_mode(c) for c in configs].index(True)
        configs = tuple(dataclasses.replace(c, cloud_lod=group // 2) if i == layer else c
                        for i, c in enumerate(configs))
        h, r0, rows = 512, 256, 256
        mk.counters.reset()
        got = _image(mk.render_scene_band_megakernel(params, configs, cam, scene.opaque, h, W,
                                                     r0, rows, tex_data=tex, pano_data=pdata,
                                                     pano_meta=pmeta))
        counts = (mk.counters.texture_launches, mk.counters.plain_calls)
        ref = _image(mk.render_scene_band_plain(params, configs, cam, scene.opaque, h, W, r0,
                                                rows, tex_data=tex, pano_data=pdata,
                                                pano_meta=pmeta))
    elif mode == "sky":
        scene, cam = _texture_scene(cuda, baked, pose, group, sky=True)
        params, configs, tex, _, _ = _plan(scene, cam, H)
        pdata, pmeta = scene._pano_plan()
        mk.counters.reset()
        got = _image(scene.render(cam, H, W))
        counts = (mk.counters.texture_launches, mk.counters.plain_calls)
        ref = _image(mk.render_scene_plain(params, configs, cam, scene.opaque, H, W,
                                           tex_data=tex, pano_data=pdata, pano_meta=pmeta))
    else:
        scene, cam = _texture_scene(cuda, baked, pose, group)
        _, params, configs = scene._sorted_layers(cam)
        config, tex = scene._texture_plan(params[0], configs[0])
        configs = (config,)
        mk.counters.reset()
        got = _image(mk.render_frame_megakernel(params[0], config, cam, scene.opaque, H, W,
                                                tex_data=tex))
        counts = (mk.counters.texture_launches, mk.counters.plain_calls)
        ref = _image(mk.render_frame_plain(params[0], config, cam, scene.opaque, H, W,
                                           tex_data=tex))
        info = mk.tex_info(mk.frame_constants(params[0], config, cam, scene.opaque, H, W),
                           mk.tex_constants(config))
        threads = mk.tex_threads(group)
        assert (info["group"], info["threads"], info["smem_bytes"]) == (
            group, threads, mk.tex_smem(group))
        assert info["blocks_per_sm"] == mk.TEX_SM_THREADS // threads  # 1 at G = 4, 2 at G = 8
    group_of = [c.cloud_lod * c.cloud_coverage_lod for c in configs if mk.texture_mode(c)]
    assert group_of == [group]
    assert counts == (1, 0)  # the texture instance, no plain call
    assert torch.isfinite(got).all() and float(got[..., 3].max()) > 0.05
    assert _cloud_ok(got, ref)


# -- flight mode: K1's depth output and temporal jitter, K3, T3 -------------------


def _cloud_ok(got, ref):
    d = (got.double() - ref.double()).abs()
    return (torch.quantile(d.flatten(), 0.999) <= 1e-3 and d.mean() <= 1e-4
            and (d.amax(dim=-1) > 1e-2).double().mean() <= 1e-3)


def _knot_group_ok(got, ref):
    """``chip_smoke.py``'s knot-group tolerance: p99 for p99.9 and at most
    0.5 % of pixels above 1e-2 (one flipped knot moves a 32-row group's
    column, 0.39 % of a 64×128 frame)."""
    d = (got.double() - ref.double()).abs()
    return (torch.quantile(d.flatten(), 0.99) <= 1e-3 and d.mean() <= 1e-4
            and (d.amax(dim=-1) > 1e-2).double().mean() <= 5e-3)


def _plain_with_longer_spans(monkeypatch, *inputs):
    """The plain frame with every coarse pixel's march span one ulp past
    its clamped end."""
    from godot_atmosphere_shader_tpu_torch.ops import clouds

    clamp = clouds.clamp_march_distance

    def longer(*args):
        t_end = clamp(*args)
        return torch.nextafter(t_end, torch.full_like(t_end, float("inf")))

    with monkeypatch.context() as m:
        m.setattr(clouds, "clamp_march_distance", longer)
        return _image(mk.render_frame_plain(*inputs, H, W))


@pytest.mark.cuda
def test_depth_output_and_temporal_jitter_match_plain(cuda):
    """The kernel's optional depth plane is the opaque pass's linear depth
    (the demo's sphere_depth_factor is 0, so it is set nonzero here), and
    a temporal-jitter frame matches the plain version."""
    scene = build_demo_scene("clouds_high", device=cuda)
    scene.atmospheres[0].set_shader_parameter("u_sphere_depth_factor", 0.5)
    cam = demo_camera("interior", device=cuda)
    scene.update(0.37, cam)
    _, params, configs = scene._sorted_layers(cam)
    config = dataclasses.replace(configs[0], temporal_jitter=True)
    struct = mk.frame_constants(params[0], config, cam, scene.opaque, H, W)
    assert 0.0 < struct.jitter_offset < 1.0
    color = torch.empty((H, W, 3), device=cuda)
    alpha = torch.empty((H, W), device=cuda)
    depth = torch.empty((H, W), device=cuda)
    mk.launch(struct, color, alpha, depth=depth)
    ref = mk.render_frame_plain(params[0], config, cam, scene.opaque, H, W)
    assert _cloud_ok(_image({"color": color, "alpha": alpha}), _image(ref))
    rel = ((depth - ref["linear_depth"]).abs() / ref["linear_depth"]).cpu()
    assert (rel > 1e-5).double().mean() <= 1e-3  # silhouette knife edges only
    assert bool((ref["linear_depth"] < 1e7).any()) and bool((ref["linear_depth"] == 1e7).any())


def _taa_planes(h, w, seed, device):
    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand((2, 3, h // 8, w // 8), generator=g)
    img = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                          align_corners=False)
    cur, hist = (x.permute(1, 2, 0).contiguous().to(device) for x in img)
    depth = 20.0 + 60.0 * torch.rand((1, 1, h // 8, w // 16), generator=g)
    depth = torch.nn.functional.interpolate(depth, size=(h, w), mode="nearest")[0, 0]
    return cur, depth.contiguous().to(device), hist


# a row shard (band mode) of a 256-row frame: 72 rows from row 64 (its last
# tile partial), against a history band of its rows and 32 halo rows
_TAA_BAND = dict(row0=64, rows=72, halo=32)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,h,w,band", [("minmax", 64, 128, False),
                                           ("variance", 72, 256, False),
                                           ("minmax", 96, 512, False),
                                           ("minmax", 256, 384, True),
                                           ("variance", 256, 384, True)])
def test_taa_kernel_matches_plain(cuda, mode, h, w, band):
    """K3 against its plain version, on whole frames and on a band shard
    with a partial last tile: validity flips at most 1e-4 of the pixels,
    max |Δ| 1e-4 where validity agrees, the depth equal."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import taa
    from godot_atmosphere_shader_tpu_torch.utils.camera import Camera, look_at

    cur, ld, hist = _taa_planes(h, w, 7, cuda)
    hd = ld * torch.where(torch.rand(ld.shape, device=cuda) < 0.1, 3.0, 1.0)
    prev = Camera.create(look_at((0.6, 0.15, 0.2), (0.5, 0.1, -10.0), device=cuda), device=cuda)
    now = Camera.create(look_at((0.0, 0.0, 0.0), (0.0, 0.0, -10.0), device=cuda), device=cuda)
    if band:
        r0, rows, halo = _TAA_BAND["row0"], _TAA_BAND["rows"], _TAA_BAND["halo"]
        p = taa.taa_constants(prev, now, 0.2, h, w, rows + 2 * halo, 0.2, mode, 1.25,
                              rows=rows, row0=r0, hist_row0=r0 - halo)
        cur, ld = cur[r0:r0 + rows].contiguous(), ld[r0:r0 + rows].contiguous()
        hist = hist[r0 - halo:r0 + rows + halo].contiguous()
        hd = hd[r0 - halo:r0 + rows + halo].contiguous()
        h = rows
    else:
        p = taa.taa_constants(prev, now, 0.2, h, w, h, 0.2, mode, 1.25)
    out, depth = torch.empty_like(cur), torch.empty_like(ld)
    valid = torch.empty((h, w), dtype=torch.uint8, device=cuda)
    taa.counters.reset()
    taa.launch(p, cur, ld, hist, hd, out, depth, valid)
    ref, ref_depth, ref_valid = taa.resolve_plain(p, cur, ld, hist, hd)
    assert taa.counters.launches == 1
    flips = valid.bool() != ref_valid
    assert int(flips.sum()) <= 1e-4 * h * w and bool(ref_valid.any()) and not bool(ref_valid.all())
    assert float((out - ref).abs().amax(dim=-1)[~flips].max()) <= 1e-4
    assert torch.equal(depth, ref_depth)


@pytest.mark.cuda
def test_taa_flight_matches_plain_flight(cuda):
    """Four TAA frames at 64×128 along a moving path: K1 and K3 four times
    each, no plain call, each frame within the cloud tolerance of the plain
    flight on the same CUDA inputs."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import taa
    from godot_atmosphere_shader_tpu_torch.render.renderer import render_flight_plain
    from godot_atmosphere_shader_tpu_torch.utils.flight import FlyCamera

    scene = build_demo_scene("clouds_high", device=cuda)
    fly = FlyCamera(position=(0.0, 0.0, 156.425))
    stack = []
    for _ in range(4):
        stack.append(fly.view_to_world())
        fly.look(0.01, 0.0).move((0.0, 0.0, -1.0))
    cam = fly.camera(device=cuda)
    times = [0.5 + i / 60.0 for i in range(4)]
    mk.counters.reset()
    taa.counters.reset()
    out = scene.render_flight(cam, times, H, W, cam_transforms=np.stack(stack), taa_blend=0.2)
    torch.cuda.synchronize()
    assert (mk.counters.megakernel_launches, taa.counters.launches) == (4, 4)
    assert mk.counters.plain_calls == 0 and taa.counters.plain_calls == 0
    _, params, configs = scene._sorted_layers(cam)
    rows = np.stack([scene.atmospheres[0].frame_state_row(t, s[:3, 3].astype(np.float64), 0.1)
                     for t, s in zip(times, stack)])
    ref = render_flight_plain(params, [rows], [dataclasses.replace(configs[0],
                                                                   temporal_jitter=True)],
                              cam, scene.opaque, H, W, cam_stack=np.stack(stack),
                              taa=taa.TaaSettings(blend=0.2))
    for i in range(4):
        assert _cloud_ok(_image({"color": out["color"][i], "alpha": out["alpha"][i]}),
                         _image({"color": ref["color"][i], "alpha": ref["alpha"][i]})), i


# -- exterior and multi-planet frames: bands, the chain, the opaque-only pass,
# v1, raymarched lighting ----------------------------------------------------------


def _two_layer_scene(device, planet="clouds_high_rm", moon="no_clouds"):
    from godot_atmosphere_shader_tpu_torch.models.scene import PlanetAtmosphere

    scene = build_demo_scene(planet, device=device)
    scene.atmospheres.append(PlanetAtmosphere(
        planet_radius=10.0, atmosphere_height=2.0, sun=scene.atmospheres[0].sun,
        custom_shader=moon, position=(-188.991, 0.0, 192.584), device=device))
    return scene


def _plan(scene, cam, h):
    order, params, configs = scene._sorted_layers(cam)
    plans = [scene._texture_plan(p, c) for p, c in zip(params, configs)]
    return scene._layer_bands(order, params, tuple(c for c, _ in plans),
                              tuple(t for _, t in plans), cam, h)[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("planet,moon,pose", [
    ("v1_no_clouds", None, "exterior"),  # a banded v1 layer
    ("clouds", None, "space"),  # a banded cloud layer over the opaque-only pass
    ("clouds_high_rm", "no_clouds", "space"),  # the chain, raymarched light
    ("clouds_high_rm", "v1_no_clouds", "space"),  # the golden's v1 moon
])
def test_scene_kernel_matches_plain_chain(cuda, planet, moon, pose):
    """Scene.render through K1 (one launch per layer and the opaque-only
    pass) against the plain chain on the same CUDA inputs, cloud
    tolerance, at 256×384 where the layers are banded."""
    h, w = 256, 384
    scene = (build_demo_scene(planet, device=cuda) if moon is None
             else _two_layer_scene(cuda, planet, moon))
    cam = demo_camera(pose, device=cuda)
    scene.update(0.5, cam)
    params, configs, tex, bands, rows = _plan(scene, cam, h)
    assert bands is not None and all(b is not None for b in bands)
    mk.counters.reset()
    got = _image(scene.render(cam, h, w))
    assert (mk.counters.megakernel_launches, mk.counters.plain_calls) == (len(configs) + 1, 0)
    ref = _image(mk.render_scene_plain(params, configs, cam, scene.opaque, h, w, tex_data=tex,
                                       bands=bands, band_rows=rows))
    assert torch.isfinite(got).all() and _cloud_ok(got, ref)


@pytest.mark.cuda
def test_opaque_only_pass_matches_plain(cuda):
    from godot_atmosphere_shader_tpu_torch.render.renderer import opaque_only_config, render_frame

    scene = _two_layer_scene(cuda)
    cam = demo_camera("space", device=cuda)
    scene.update(0.5, cam)
    params, configs, tex, bands, rows = _plan(scene, cam, 256)
    kind, struct, _ = mk.scene_launches(params, configs, cam, scene.opaque, 256, 384,
                                        tex_data=tex, bands=bands, band_rows=rows)[0]
    assert kind == "opaque" and struct.with_atmosphere == 0
    color = torch.empty((256, 384, 3), device=cuda)
    alpha = torch.full((256, 384), 7.0, device=cuda)
    depth = torch.empty((256, 384), device=cuda)
    mk.launch(struct, color, alpha, depth=depth)
    ref = render_frame(params[0], opaque_only_config(configs[0]), cam, scene.opaque, 256, 384,
                       with_atmosphere=False)
    assert float(alpha.abs().max()) == 0.0
    assert _cloud_ok(_image({"color": color, "alpha": alpha}), _image(ref))
    rel = ((depth - ref["linear_depth"]).abs() / ref["linear_depth"]).cpu()
    assert (rel > 1e-5).double().mean() <= 1e-3


@pytest.mark.cuda
def test_banded_layer_writes_only_its_rows(cuda):
    """A chained band composites in place: rows outside it keep the planes'
    values, and its alpha is the maximum with the alpha below."""
    scene = build_demo_scene("clouds", device=cuda)
    cam = demo_camera("space", device=cuda)
    scene.update(0.5, cam)
    params, configs, tex, bands, rows = _plan(scene, cam, 256)
    _, struct, _ = mk.scene_launches(params, configs, cam, scene.opaque, 256, 384,
                                     tex_data=tex, bands=bands, band_rows=rows)[1]
    color = torch.full((256, 384, 3), 0.25, device=cuda)
    alpha = torch.full((256, 384), 0.5, device=cuda)
    depth = torch.full((256, 384), 1e7, device=cuda)
    mk.launch(struct, color, alpha, depth=depth)
    r0, r1 = struct.row0, struct.row0 + struct.rows
    outside = torch.cat([color[:r0], color[r1:]])
    assert bool((outside == 0.25).all()) and bool((torch.cat([alpha[:r0], alpha[r1:]]) == 0.5).all())
    assert float(alpha[r0:r1].min()) >= 0.5 and bool((color[r0:r1] != 0.25).any())


@pytest.mark.cuda
def test_two_layer_taa_flight_matches_plain_flight(cuda):
    from godot_atmosphere_shader_tpu_torch.ops.kernels import taa
    from godot_atmosphere_shader_tpu_torch.render.renderer import render_flight_plain
    from godot_atmosphere_shader_tpu_torch.utils.camera import Camera, look_at

    scene = _two_layer_scene(cuda, "clouds")
    stack = np.stack([look_at((0.4 * i, 150.0, 420.0 - 0.6 * i), (0.0, 0.0, 0.0),
                              device="cpu").numpy() for i in range(3)])
    cam = Camera.create(stack[0], device=cuda)
    times = [0.5 + i / 60.0 for i in range(3)]
    mk.counters.reset()
    taa.counters.reset()
    out = scene.render_flight(cam, times, H, W, cam_transforms=stack, taa_blend=0.2)
    torch.cuda.synchronize()
    assert (mk.counters.megakernel_launches, taa.counters.launches) == (6, 3)
    order, params, configs = scene._sorted_layers(cam)
    fs = [np.stack([a.frame_state_row(t, s[:3, 3].astype(np.float64), 0.1)
                    for t, s in zip(times, stack)]) for a in order]
    ref = render_flight_plain(params, fs, [dataclasses.replace(c, temporal_jitter=True)
                                           for c in configs],
                              cam, scene.opaque, H, W, cam_stack=stack,
                              taa=taa.TaaSettings(blend=0.2))
    for i in range(3):
        assert _cloud_ok(_image({"color": out["color"][i], "alpha": out["alpha"][i]}),
                         _image({"color": ref["color"][i], "alpha": ref["alpha"][i]})), i


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,offset", [(1, 1, 0), (1080, 1920, 0), (1081, 1923, 0),
                                        (1080, 1920, 1)])
def test_fill_probe_matches_torch_full(cuda, h, w, offset):
    """A plane of one pixel, 1080p, a ragged width and height, and a plane
    one float off 16-byte alignment; nothing outside the plane written."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import probes

    flat = torch.zeros(h * w + offset, device=cuda)
    probes.counters.reset()
    probes.launch_fill(0.25, flat[offset:].view(h, w))
    assert probes.counters.launches == 1
    assert torch.equal(flat[offset:].view(h, w), torch.full((h, w), 0.25, device=cuda))
    assert not flat[:offset].any()
    assert torch.equal(probes.fill(0.5, h, w, device=cuda), torch.full((h, w), 0.5, device=cuda))


@pytest.mark.cuda
def test_fill_probe_under_graph_capture(cuda):
    """Captured into a CUDA graph, the launches go to the capture stream:
    each replay writes the planes."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import probes

    planes = torch.zeros((3, 64, 256), device=cuda)
    probes.launch_fill(0.0, planes[0])  # the module loaded before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(3):
            probes.launch_fill(float(i + 1), planes[i])
    planes.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(planes[i], torch.full_like(planes[i], i + 1.0)) for i in range(3))


@pytest.mark.cuda
def test_fill_probe_on_a_side_stream(cuda):
    """Under ``torch.cuda.stream(s)`` the launch goes to ``s``: it runs
    while the default stream sleeps, and work on the default stream that
    waits for ``s`` sees it."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import probes

    side = torch.cuda.Stream()
    plane = torch.zeros((256, 512), device=cuda)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # about a second on the default stream
    with torch.cuda.stream(side):
        probes.launch_fill(1.0, plane)
        seen = plane.cpu()  # copied on the side stream
    busy = not torch.cuda.current_stream().query()
    torch.cuda.current_stream().wait_stream(side)
    plane.add_(1.0)
    torch.cuda.synchronize()
    assert busy and torch.equal(seen, torch.ones((256, 512)))
    assert torch.equal(plane, torch.full_like(plane, 2.0))


# -- the panorama sky (K1 slice (f)) ---------------------------------------------


def _with_panorama(scene, device, shape=(256, 512, 3)):
    pano = np.random.default_rng(0).random(shape).astype(np.float32) * 0.5
    scene.opaque = dataclasses.replace(scene.opaque, panorama=torch.as_tensor(pano, device=device))
    return scene


@pytest.mark.cuda
@pytest.mark.parametrize("planet,moon,pose", [
    ("no_clouds", None, "avatar"),  # the procedural instance fuses the sky
    ("clouds_high", None, "avatar"),
    ("clouds_high_rm", "no_clouds", "space"),  # the opaque-only pass draws it
])
def test_sky_kernel_matches_plain(cuda, planet, moon, pose):
    """Scene.render with a panorama through K1 only (no plain call, no
    plain sky sampler call) against the plain chain on the same CUDA
    inputs, cloud tolerance, 256×384."""
    h, w = 256, 384
    scene = (build_demo_scene(planet, device=cuda) if moon is None
             else _two_layer_scene(cuda, planet, moon))
    _with_panorama(scene, cuda)
    cam = demo_camera(pose, device=cuda)
    scene.update(0.5, cam)
    params, configs, tex, bands, rows = _plan(scene, cam, h)
    pdata, pmeta = scene._pano_plan()
    mk.counters.reset()
    ts.counters.reset()
    got = _image(scene.render(cam, h, w))
    torch.cuda.synchronize()
    launches = len(configs) + int(bands is not None and bands[0] is not None)
    assert (mk.counters.megakernel_launches, mk.counters.sky_launches,
            mk.counters.sky_choice_launches) == (launches, 1, 1)
    assert mk.counters.plain_calls == 0 and ts.counters.plain_sky_calls == 0
    ref = _image(mk.render_scene_plain(params, configs, cam, scene.opaque, h, w, tex_data=tex,
                                       bands=bands, band_rows=rows, pano_data=pdata,
                                       pano_meta=pmeta))
    assert torch.isfinite(got).all() and _cloud_ok(got, ref)


@pytest.mark.cuda
def test_sky_texture_kernel_matches_plain(cuda, baked):
    scene = _with_panorama(build_demo_scene("clouds_high", procedural=False, device=cuda,
                                            textures=baked), cuda)
    cam = demo_camera("avatar", device=cuda)
    scene.update(0.5, cam)
    params, configs, tex, _, _ = _plan(scene, cam, H)
    pdata, pmeta = scene._pano_plan()
    mk.counters.reset()
    ts.counters.reset()
    got = _image(scene.render(cam, H, W))
    assert (mk.counters.texture_launches, mk.counters.sky_launches,
            mk.counters.sky_choice_launches) == (1, 1, 0)  # the tile is the block
    assert mk.counters.plain_calls == 0 and ts.counters.plain_sky_calls == 0
    ref = _image(mk.render_scene_plain(params, configs, cam, scene.opaque, H, W, tex_data=tex,
                                       pano_data=pdata, pano_meta=pmeta))
    assert _cloud_ok(got, ref)


@pytest.mark.cuda
def test_sky_tables_on_another_device_raise(cuda):
    scene = _with_panorama(build_demo_scene("no_clouds", device=cuda), cuda)
    cam = demo_camera("avatar", device=cuda)
    scene.update(0.5, cam)
    _, params, configs = scene._sorted_layers(cam)
    pdata, pmeta = scene._pano_plan()
    with pytest.raises(ValueError):
        mk.render_scene_megakernel(params, configs, cam, scene.opaque, H, W,
                                   pano_data=tuple(t.cpu() for t in pdata), pano_meta=pmeta)
    with pytest.raises(ValueError):  # a panorama never falls back to the exact sampler
        mk.render_scene_megakernel(params, configs, cam, scene.opaque, H, W)


@pytest.mark.cuda
@pytest.mark.parametrize("pose,h,w", [("avatar", 256, 384), ("space", 72, 200),
                                      ("avatar", 1080, 1920)])
def test_sky_choice_prepass_matches_plain(cuda, pose, h, w):
    """The sky's per-tile choice pre-pass alone against its plain version on
    the same camera: the same mode and level in every tile."""
    scene = _with_panorama(build_demo_scene("no_clouds", device=cuda), cuda, (1024, 2048, 3))
    cam = demo_camera(pose, device=cuda)
    scene.update(0.5, cam)
    _, params, configs = scene._sorted_layers(cam)
    pdata, pmeta = scene._pano_plan()
    struct = mk.frame_constants(params[0], configs[0], cam, scene.opaque, h, w)
    mk.counters.reset()
    got = mk.sky_choices(struct, mk.sky_constants(pmeta), cuda)
    assert mk.counters.sky_choice_launches == 1
    ref = mk.sky_choices_plain(cam, h, w, pmeta)
    assert got.shape == (-(-h // 32) * -(-w // 128), 2)
    assert torch.equal(got.cpu(), ref.cpu())


# -- row shards (K1 slice (g)) and K3's band mode ---------------------------------


def _shard_scene(device, textures=None):
    """``clouds_high`` (texture mode with ``textures``) with a far moon and a
    panorama at the avatar pose: what the band entries take for it."""
    scene = _with_panorama(_two_layer_scene(device, "clouds_high") if textures is None else
                           build_demo_scene("clouds_high", procedural=False, device=device,
                                            textures=textures), device)
    if textures is not None:
        from godot_atmosphere_shader_tpu_torch.models.scene import PlanetAtmosphere

        scene.atmospheres.append(PlanetAtmosphere(
            planet_radius=10.0, atmosphere_height=2.0, sun=scene.atmospheres[0].sun,
            custom_shader="no_clouds", position=(-188.991, 0.0, 192.584), device=device))
    cam = demo_camera("avatar", device=device)
    scene.update(0.5, cam)
    _, params, configs = scene._sorted_layers(cam)
    plans = [scene._texture_plan(p, c) for p, c in zip(params, configs)]
    pdata, pmeta = scene._pano_plan()
    return (scene, cam, params, tuple(c for c, _ in plans), tuple(t for _, t in plans), pdata,
            pmeta)


@pytest.mark.cuda
@pytest.mark.parametrize("textured", [False, True])
def test_band_entries_match_plain(cuda, baked, textured):
    """Two 32-row shards of a 64×128 frame through ``render_scene_band_megakernel``:
    one K1 launch per layer (the moon's fused with the sky and its
    pre-pass), no plain call; each within the cloud tolerance of the plain
    band chain on the same CUDA inputs, its depth the opaque pass's."""
    scene, cam, params, configs, tex, pdata, pmeta = _shard_scene(cuda, baked if textured else None)
    for r0 in (0, 32):
        mk.counters.reset()
        ts.counters.reset()
        got = mk.render_scene_band_megakernel(params, configs, cam, scene.opaque, H, W, r0, 32,
                                              tex_data=tex, pano_data=pdata, pano_meta=pmeta)
        torch.cuda.synchronize()
        assert (mk.counters.megakernel_launches, mk.counters.sky_launches,
                mk.counters.sky_choice_launches, mk.counters.texture_launches) == (
                    2, 1, 1, int(textured))
        assert mk.counters.plain_calls == 0 and ts.counters.plain_sky_calls == 0
        ref = mk.render_scene_band_plain(params, configs, cam, scene.opaque, H, W, r0, 32,
                                         tex_data=tex, pano_data=pdata, pano_meta=pmeta)
        assert got["color"].shape == (32, W, 3) and _cloud_ok(_image(got), _image(ref))
        rel = ((got["linear_depth"] - ref["linear_depth"]).abs() / ref["linear_depth"]).cpu()
        assert (rel > 1e-5).double().mean() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("row0,rows", [(540, 540), (256, 256), (0, 1080)])
def test_sky_choice_prepass_on_a_band_matches_plain(cuda, row0, rows):
    scene, cam, params, configs, tex, pdata, pmeta = _shard_scene(cuda)
    _, struct, args = mk.band_launches(params, configs, cam, scene.opaque, 1080, 1920, row0, rows,
                                       tex_data=tex, pano_data=pdata, pano_meta=pmeta)[0]
    got = mk.sky_choices(struct, args["sky"][0], cuda)
    ref = mk.sky_choices_plain(cam, 1080, 1920, pmeta, row0=row0, rows=rows)
    assert torch.equal(got.cpu(), ref.cpu())


@pytest.mark.cuda
def test_taa_band_mode_matches_plain_and_reassembles_the_full_frame(cuda):
    """K3 on four 64-row shards with 32 halo rows (zeros past the frame's
    edges) against its plain version, bit for bit, and put together equal
    to the full-frame launch, bit for bit."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import taa
    from godot_atmosphere_shader_tpu_torch.utils.camera import Camera, look_at

    h, w, rows, halo = 256, 384, 64, 32
    cur, ld, hist = _taa_planes(h, w, 11, cuda)
    prev = Camera.create(look_at((0.3, 0.4, 0.2), (0.3, 0.2, -10.0), device=cuda), device=cuda)
    now = Camera.create(look_at((0.0, 0.0, 0.0), (0.0, 0.0, -10.0), device=cuda), device=cuda)
    p = taa.taa_constants(prev, now, 0.2, h, w, h)
    full, full_depth = torch.empty_like(cur), torch.empty_like(ld)
    taa.launch(p, cur, ld, hist, ld, full, full_depth)
    zeros = lambda t: torch.zeros((halo,) + tuple(t.shape[1:]), device=cuda)  # noqa: E731
    hp = torch.cat([zeros(hist), hist, zeros(hist)])
    dp = torch.cat([zeros(ld), ld, zeros(ld)])
    taa.counters.reset()
    bands = []
    for r0 in range(0, h, rows):
        pb = taa.taa_constants(prev, now, 0.2, h, w, rows + 2 * halo, rows=rows, row0=r0,
                               hist_row0=r0 - halo)
        args = (cur[r0:r0 + rows], ld[r0:r0 + rows], hp[r0:r0 + rows + 2 * halo].contiguous(),
                dp[r0:r0 + rows + 2 * halo].contiguous())
        out, depth = torch.empty_like(args[0]), torch.empty_like(args[1])
        taa.launch(pb, *args, out, depth)
        ref, ref_depth, _ = taa.resolve_plain(pb, *args)
        assert torch.equal(out, ref) and torch.equal(depth, ref_depth)
        bands.append(out)
    assert taa.counters.launches == h // rows
    assert torch.equal(torch.cat(bands), full)


@pytest.mark.cuda
def test_sharded_taa_flight_matches_plain(cuda):
    """Three frames on 2 shards of 32 rows: K1 2·layers·K and K3 2·K launches,
    no plain call, each frame within the cloud tolerance of the plain
    sharded flight on the same CUDA inputs."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import taa
    from godot_atmosphere_shader_tpu_torch.parallel import sharding
    from godot_atmosphere_shader_tpu_torch.utils.flight import FlyCamera

    scene = _with_panorama(build_demo_scene("clouds_high", device=cuda), cuda)
    fly = FlyCamera(position=(0.0, 0.0, 156.425), speed=10.0)
    stack = []
    for _ in range(3):
        stack.append(fly.view_to_world())
        fly.look(0.004, 0.003).move((0.0, 0.0, -1.0), dt=1 / 60)
    stack = np.stack(stack)
    cam = fly.camera(device=cuda)
    times = [0.5 + i / 60.0 for i in range(3)]
    mesh = sharding.make_mesh(2)
    mk.counters.reset()
    taa.counters.reset()
    out = scene.render_flight(cam, times, H, W, cam_transforms=stack, taa_blend=0.2, mesh=mesh)
    torch.cuda.synchronize()
    assert (mk.counters.megakernel_launches, taa.counters.launches) == (6, 6)
    assert mk.counters.plain_calls == 0 and taa.counters.plain_calls == 0
    order, params, configs = scene._sorted_layers(cam)
    fs = [np.stack([a.frame_state_row(t, s[:3, 3].astype(np.float64), 0.1)
                    for t, s in zip(times, stack)]) for a in order]
    pdata, pmeta = scene._pano_plan()
    ref = sharding.render_flight_taa_sharded_plain(params, fs, configs, cam, scene.opaque, H, W,
                                                   mesh, cam_stack=stack, blend=0.2,
                                                   pano_data=pdata, pano_meta=pmeta)
    for i in range(3):
        assert _cloud_ok(_image({"color": out["color"][i], "alpha": out["alpha"][i]}),
                         _image({"color": ref["color"][i], "alpha": ref["alpha"][i]})), i


@pytest.mark.cuda
@pytest.mark.parametrize("change", [dict(cloud_shape_interp=False), dict(cloud_lod=3),
                                    dict(texture_band_rows=12)])
def test_card_refuses_configs_outside_the_kernel(cuda, baked, change):
    """What stays outside the kernel is what the JAX kernel's
    ``_check_config`` refuses too (a baked field without its knot flag,
    banded rows not a multiple of 8) and a LOD group that does not divide
    the tile: the card raises."""
    scene = build_demo_scene("clouds", procedural=False, device=cuda, textures=baked)
    cam = demo_camera("avatar", device=cuda)
    scene.update(0.5, cam)
    _, params, configs = scene._sorted_layers(cam)
    config, tex = scene._texture_plan(params[0], configs[0])
    with pytest.raises(ValueError):
        mk.render_frame_megakernel(params[0], dataclasses.replace(config, **change), cam,
                                   scene.opaque, H, W, tex_data=tex)


# -- K1 slice (i): the texture envelope -------------------------------------------


@pytest.fixture(scope="module")
def tex_conditioning(baked):
    """What one ulp moves the texture-mode plain frame by on this card
    (``chip_smoke.py``: the camera at full quality, every march span over
    coverage groups of 32 rows)."""
    import chip_smoke as cs

    return cs.tex_envelope_conditioning(torch.device("cuda", 0), baked, H, W)


def _tex_envelope_cases():
    import chip_smoke as cs

    return list(cs.TEX_ENVELOPE_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _tex_envelope_cases())
def test_texture_envelope_matches_plain(cuda, baked, tex_conditioning, case):
    """A texture config beyond the demo's profile (``chip_smoke.py`` phase
    3h's cases) through ``Scene.render``: one launch of a texture instance,
    the general one unless the config is the fixed instance's (as the
    launcher reports it, and as ``mk.fixed_texture_instance`` mirrors), no
    plain call; against the plain version on the same CUDA inputs at the cloud
    tolerance, full quality at the detail tolerance and coverage groups of
    32 rows at the knot-group tolerance each only where one ulp moves the
    plain frame itself beyond the cloud tolerance (``tex_conditioning``)."""
    import chip_smoke as cs

    scene, cam = cs.tex_envelope_scene(cs.TEX_ENVELOPE_CASES[case], cuda, baked)
    params, configs, tex, bands, rows = cs.scene_plan(scene, cam, H)
    mk.check_config(configs[0])
    (_, struct, args), = mk.scene_launches(params, configs, cam, scene.opaque, H, W,
                                           tex_data=tex, bands=bands, band_rows=rows)
    mk.counters.reset()
    got = cs.frame_array(scene.render(cam, H, W))
    assert (mk.counters.megakernel_launches, mk.counters.texture_launches,
            mk.counters.texture_general_launches, mk.counters.plain_calls) == (
                1, 1, int(not mk.fixed_texture_instance(struct, args["tex"][0])), 0)
    config = configs[0]
    ref = cs.plain_scene_frame(scene, cam, H, W)
    ok, tolerance = cs.tex_envelope_tolerance(config, tex_conditioning)
    st = cs.cloud_deltas(got, ref)
    assert np.isfinite(got).all() and float(got[..., 3].max()) > 0.05
    assert ok(st), (tolerance, st)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _tex_envelope_cases())
def test_texture_instance_and_layout_match_the_launcher(cuda, baked, case):
    """The launcher's pick of a texture instance and the general instance's
    two blocks (``megakernel_tex_info``) against their mirrors in the
    wrapper: ``mk.fixed_texture_instance`` (the general instance exactly
    where it is false) and ``mk.tex_general_layout`` (the frame's threads
    and shared memory, the tile pass's threads and shared memory, the
    general instance also where it is asked for on a fixed config)."""
    import chip_smoke as cs

    scene, cam = cs.tex_envelope_scene(cs.TEX_ENVELOPE_CASES[case], cuda, baked)
    params, configs, tex, bands, rows = cs.scene_plan(scene, cam, H)
    (_, struct, args), = mk.scene_launches(params, configs, cam, scene.opaque, H, W,
                                           tex_data=tex, bands=bands, band_rows=rows)
    tparams = args["tex"][0]
    lay = mk.tex_general_layout(configs[0])
    picked = mk.tex_info(struct, tparams)
    assert picked["general"] == int(not mk.fixed_texture_instance(struct, tparams))
    general = mk.tex_info(struct, tparams, general=True)
    assert general["general"] == 1
    keys = ("threads", "smem_bytes", "choice_threads", "choice_smem_bytes")
    assert {k: general[k] for k in keys} == {k: lay[k] for k in keys}
    assert general["blocks_per_sm"] >= 1 and general["choice_blocks_per_sm"] >= 1
    if picked["general"]:
        assert picked == general


@pytest.mark.cuda
@pytest.mark.parametrize("case", _tex_envelope_cases())
def test_tex_choices_match_plain(cuda, baked, case):
    """The tile choices of a launch of the general texture instance (the
    buffer its tile pass wrote, as ``mk.launch(general=True)`` returns it;
    the tile pass counted once) against their plain version
    (``mk.tex_choices_plain``, the plain chain's own per-tile batch
    choices) on the same CUDA inputs: the same (mode, level) in every slot
    of every tile, exactly."""
    import chip_smoke as cs

    scene, cam = cs.tex_envelope_scene(cs.TEX_ENVELOPE_CASES[case], cuda, baked)
    params, configs, tex, bands, rows = cs.scene_plan(scene, cam, H)
    (_, struct, args), = mk.scene_launches(params, configs, cam, scene.opaque, H, W,
                                           tex_data=tex, bands=bands, band_rows=rows)
    mk.counters.reset()
    got = mk.launch(struct, torch.empty((H, W, 3), device=cuda), torch.empty((H, W), device=cuda),
                    general=True, **args)
    assert (mk.counters.texture_general_launches, mk.counters.tex_choice_launches) == (1, 1)
    ref = mk.tex_choices_plain(params[0], configs[0], cam, scene.opaque, H, W, tex[0])
    assert got.shape == ref.shape == mk.tex_choice_shape(struct, args["tex"][0])
    assert torch.equal(got.cpu(), ref.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["G = 1", "shape baked, coverage knots", "full quality"])
@pytest.mark.parametrize("mode", ["chained", "sky"])
def test_texture_general_instance_chained_and_with_the_sky(cuda, baked, mode, case):
    """The general texture instance where ``test_texture_kernel_matches_plain``
    takes the fixed one: chained over a far moon on a 256-row shard (rows
    256-511 of a 512×128 frame, through the band entries), and fused with
    a panorama sky (its choice made by the instance's tile pass, no sky
    pre-pass); against the plain version on the same CUDA inputs at the
    cloud tolerance; the tile choices of its launch against their plain
    version, exactly, on the same inputs (chained: the layer below as the
    kernel rendered it)."""
    import chip_smoke as cs
    from godot_atmosphere_shader_tpu_torch.models.scene import PlanetAtmosphere

    scene, cam = cs.tex_envelope_scene(cs.TEX_ENVELOPE_CASES[case], cuda, baked)
    _with_panorama(scene, cuda)
    if mode == "chained":
        scene.atmospheres.append(PlanetAtmosphere(
            planet_radius=10.0, atmosphere_height=2.0, sun=scene.atmospheres[0].sun,
            custom_shader="no_clouds", position=(-188.991, 0.0, 192.584), device=cuda))
    scene.update(0.5, cam)
    _, params, configs = scene._sorted_layers(cam)
    plans = [scene._texture_plan(p, c) for p, c in zip(params, configs)]
    configs, tex = tuple(c for c, _ in plans), tuple(t for _, t in plans)
    pdata, pmeta = scene._pano_plan()
    textured = [mk.texture_mode(c) for c in configs]
    assert textured == ([False, True] if mode == "chained" else [True])
    mk.counters.reset()
    if mode == "chained":
        h, r0, rows = 512, 256, 256
        got = _image(mk.render_scene_band_megakernel(params, configs, cam, scene.opaque, h, W,
                                                     r0, rows, tex_data=tex, pano_data=pdata,
                                                     pano_meta=pmeta))
        counts = (mk.counters.texture_general_launches, mk.counters.sky_launches,
                  mk.counters.plain_calls)
        ref = _image(mk.render_scene_band_plain(params, configs, cam, scene.opaque, h, W, r0,
                                                rows, tex_data=tex, pano_data=pdata,
                                                pano_meta=pmeta))
    else:
        got = _image(scene.render(cam, H, W))
        counts = (mk.counters.texture_general_launches, mk.counters.sky_launches,
                  mk.counters.plain_calls + mk.counters.sky_choice_launches)
        ref = _image(mk.render_scene_plain(params, configs, cam, scene.opaque, H, W,
                                           tex_data=tex, pano_data=pdata, pano_meta=pmeta))
    assert counts == (1, 1, 0)
    assert torch.isfinite(got).all() and float(got[..., 3].max()) > 0.05
    assert _cloud_ok(got, ref)
    if mode == "chained":
        launches = mk.band_launches(params, configs, cam, scene.opaque, h, W, r0, rows,
                                    tex_data=tex, pano_data=pdata, pano_meta=pmeta)
        planes = [torch.empty((rows, W) + c, device=cuda) for c in ((3,), (), ())]
        _, below, below_args = launches[0]
        mk.launch(below, *planes[:2], depth=planes[2], **below_args)
        background = (planes[0].clone(), planes[2].clone())
        _, struct, args = launches[1]
        got_choice = mk.launch(struct, *planes[:2], depth=planes[2], **args)
        ref_choice = mk.tex_choices_plain(params[1], configs[1], cam, None, h, W, tex[1],
                                          background=background, row0=r0, rows=rows)
    else:
        (_, struct, args), = mk.scene_launches(params, configs, cam, scene.opaque, H, W,
                                               tex_data=tex, pano_data=pdata, pano_meta=pmeta)
        got_choice = mk.launch(struct, torch.empty((H, W, 3), device=cuda),
                               torch.empty((H, W), device=cuda), **args)
        ref_choice = mk.tex_choices_plain(params[0], configs[0], cam, scene.opaque, H, W,
                                          tex[0], pano_meta=pmeta)
    assert bool((got_choice[:, 0, 0] >= 0).all()) == (mode == "sky")
    assert torch.equal(got_choice.cpu(), ref_choice.cpu())


# -- K1 slice (h): the procedural envelope, the procedural instance ----------------


def _field(field, **kw):
    return dataclasses.replace(field, noise=dataclasses.replace(field.noise, **kw))


def _envelope(case):
    """The flagship clouds_high config changed as the case says."""
    from godot_atmosphere_shader_tpu_torch.models.demo import (COVERAGE_NOISE, COVERAGE_SCALE,
                                                               SHAPE_NOISE_BAKE, demo_variant)
    from godot_atmosphere_shader_tpu_torch.models.params import ProceduralField

    cfg = demo_variant("clouds_high")
    shape, cov = cfg.cloud_shape_noise, cfg.cloud_coverage_noise
    change = {
        "cellular_tier": dict(cloud_shape_noise=_field(shape, noise_type="cellular_fast")),
        "per_step_coverage": dict(cloud_coverage_interp=False, cloud_lod=1,
                                  cloud_coverage_lod=1, knot_dynamic=False),
        "tscn_profile": dict(cloud_shape_noise=ProceduralField(SHAPE_NOISE_BAKE, (64.0,) * 3),
                             cloud_coverage_noise=ProceduralField(COVERAGE_NOISE, COVERAGE_SCALE),
                             cloud_steps=32, cloud_lod=1, cloud_coverage_lod=1,
                             knot_dynamic=False),
        "detail_per_step": dict(clouds_always_low_quality=False),
        "detail_knots_raymarched": dict(clouds_always_low_quality=False, cloud_shape_interp=True,
                                        raymarched_lighting=True),
        "perlin_coverage": dict(cloud_coverage_noise=_field(cov, noise_type="perlin")),
        "simplex_shape": dict(cloud_shape_noise=_field(shape, noise_type="simplex")),
        "cellular_cell_value_shape": dict(cloud_shape_noise=_field(
            shape, noise_type="cellular", cellular_return="cell_value")),
        "ping_pong_weighted": dict(cloud_shape_noise=_field(shape, fractal_type="ping_pong",
                                                            weighted_strength=0.5)),
        "coverage_k16": dict(cloud_coverage_knots=16),
        "shape_knots_32": dict(cloud_shape_interp=True, cloud_shape_knots=32),
        "group_32": dict(cloud_lod=16, cloud_coverage_lod=2, cloud_lod_interior=0),
    }[case]
    return dataclasses.replace(cfg, **change)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cellular_tier", "per_step_coverage", "tscn_profile",
                                  "detail_per_step", "detail_knots_raymarched",
                                  "perlin_coverage", "simplex_shape",
                                  "cellular_cell_value_shape", "ping_pong_weighted",
                                  "coverage_k16", "shape_knots_32", "group_32"])
def test_general_instance_matches_plain(cuda, case):
    """Scene.render of an envelope config through the procedural instance (one
    K1 launch, no plain call) against the plain version on the same CUDA
    inputs: the cloud tolerance, p99 in place of p99.9 at full quality (the
    detail field: one ulp of a position moves a pixel by ~1e-3)."""
    scene = build_demo_scene("clouds_high", device=cuda)
    config = _envelope(case)
    scene.atmospheres[0].set_custom_shader(config)
    cam = demo_camera("avatar", device=cuda)
    scene.update(0.5, cam)
    _, params, configs = scene._sorted_layers(cam)
    mk.counters.reset()
    got = _image(scene.render(cam, H, W))
    torch.cuda.synchronize()
    assert (mk.counters.megakernel_launches, mk.counters.general_launches,
            mk.counters.plain_calls) == (1, 1, 0)
    ref = _image(mk.render_frame_plain(params[0], configs[0], cam, scene.opaque, H, W))
    d = (got.double() - ref.double()).abs()
    q = 0.999 if config.clouds_always_low_quality else 0.99
    assert torch.isfinite(got).all() and float(got[..., 3].max()) > 0.05
    assert torch.quantile(d.flatten(), q) <= 1e-3 and d.mean() <= 1e-4
    assert (d.amax(dim=-1) > 1e-2).double().mean() <= 1e-3


@pytest.mark.cuda
def test_peak_probe_matches_plain(cuda):
    """T2's chains against their plain version at a small iteration count:
    fmaf against a multiply then an add, expf and __expf against torch.exp,
    uint32 exact."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import probes

    g = torch.Generator().manual_seed(3)
    a = (torch.rand(2048, generator=g) * 0.5 + 0.25).to(cuda)
    b = (torch.rand(2048, generator=g) * 0.1).to(cuda)
    probes.counters.reset()
    for op, tol in (("fma", 1e-5), ("exp", 1e-5), ("fast_exp", 1e-4), ("imad", 0.0)):
        got = probes.peak_chains(a, b, op, 16, 8).reshape(-1, 2048)
        ref = probes.chains_plain(a, b, op, 16)
        assert float((got - ref).abs().max()) <= tol, op
    assert probes.counters.peak_launches == 4


@pytest.mark.cuda
def test_card_refuses_an_unpackable_texture(cuda):
    """A texture the pyramid builders refuse: the kernel's plan refuses the
    scene before any launch, so ``renderer="kernel"`` raises and
    ``renderer="auto"`` renders the plain chain on the card, sampling the
    texture exactly (as the JAX package renders it by XLA); the kernel's
    own envelope (``check_config``) still refuses the config."""
    scene = build_demo_scene("clouds", procedural=False, device=cuda, textures=(
        torch.rand((12, 12, 12), device=cuda), torch.rand((6, 32, 32), device=cuda)))
    cam = demo_camera("avatar", device=cuda)
    scene.update(0.5, cam)
    with pytest.raises(ValueError, match="kernel renderer"):
        scene.render(cam, H, W, renderer="kernel")
    mk.counters.reset()
    out = scene.render(cam, H, W)
    assert (mk.counters.megakernel_launches, mk.counters.plain_calls) == (0, 1)
    assert torch.isfinite(out["color"]).all()
    with pytest.raises(ValueError, match="pyramid metas"):
        mk.check_config(scene.atmospheres[0].effective_config())


@pytest.mark.cuda
def test_launch_struct_mirrors_match_the_built_kernels(cuda):
    """The library's own sizes of the launch structs against the ctypes
    mirrors (``TaaParams`` with its band fields)."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import taa

    mk.load_library()
    taa._launcher()


# -- the procedural instance's redesign: one instance per C, the row cache, the
# march list ------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("lod,coverage_lod,change,row_cache", [
    (2, 1, {}, 1), (2, 2, {}, 1), (2, 4, {}, 1), (2, 8, {}, 1), (2, 16, {}, 1), (1, 32, {}, 1),
    (2, 2, dict(cloud_shape_interp=True, cloud_shape_knots=420), 0),
    (1, 32, dict(cloud_coverage_knots=200), 0),
    (1, 32, dict(cloud_shape_interp=True, cloud_shape_knots=16), 1),
    (2, 16, dict(cloud_shape_interp=True, cloud_shape_knots=100), 1),
])
def test_every_coarse_instance_matches_plain(cuda, monkeypatch, lod, coverage_lod, change,
                                             row_cache):
    """``megakernel_gen<C>`` for every C the launcher takes, with the row
    cache (one opaque pass per pixel) and, where the knots and the march
    inputs leave it no room, without it, against the plain version.  Shape
    knots over a coverage group of 32 rows are held to the knot-group
    tolerance (``chip_smoke.py`` ``knot_group_tolerance_ok``) only where its
    reason holds on this card: one ulp of every march span moves the plain
    frame itself beyond the cloud tolerance
    (``tests/test_torch_envelope_coarse.py`` shows it on the CPU)."""
    params, config, cam, opaque = _inputs("clouds_high", "avatar", cuda)
    config = dataclasses.replace(config, cloud_lod=lod, cloud_coverage_lod=coverage_lod,
                                 **change)
    struct = mk.frame_constants(params, config, cam, opaque, H, W)
    info = mk.gen_info(struct)
    assert (info["coarse"], info["row_cache"]) == (coverage_lod, row_cache)
    assert info["smem_bytes"] == mk.gen_smem(config)[0] and info["blocks_per_sm"] >= 1
    mk.counters.reset()
    got = _image(mk.render_frame_megakernel(params, config, cam, opaque, H, W))
    ref = _image(mk.render_frame_plain(params, config, cam, opaque, H, W))
    assert mk.counters.general_launches == 1
    d = (got.double() - ref.double()).abs()
    ok = _cloud_ok
    if config.cloud_shape_interp and lod * coverage_lod == 32:
        moved = _plain_with_longer_spans(monkeypatch, params, config, cam, opaque)
        if not _cloud_ok(moved, ref):
            ok = _knot_group_ok
    assert float(got[..., 3].max()) > 0.05 and ok(got, ref), (
        float(torch.quantile(d.flatten(), 0.999)), float(d.mean()), float(d.max()))


@pytest.mark.cuda
def test_march_across_the_shell_edge(cuda):
    """The exterior pose puts the shell's edge across the frame: most
    coverage groups miss the shell or are culled (612 of the 4,096 coarse
    pixels march), so a warp marches with lanes idle; the frame matches
    plain, and the march's lane counters add up: a warp issues coarse pixel
    k's march where any of its lanes marches it."""
    params, config, cam, opaque = _inputs("clouds_high", "exterior", cuda)
    struct = mk.frame_constants(params, config, cam, opaque, H, W)
    color = torch.empty((H, W, 3), device=cuda)
    alpha = torch.empty((H, W), device=cuda)
    work = mk.work_counts(struct, color, alpha)
    coarse = H // config.cloud_lod * W
    assert 0.1 <= work["march"] / coarse <= 0.9, work
    steps, c = config.cloud_steps, config.cloud_coverage_lod
    warps = W // 32 * (H // (config.cloud_lod * c))
    assert work["march_lane_steps"] == work["march"] * steps
    assert work["march_warp_steps"] % steps == 0
    assert work["march"] / 32 < work["march_warp_steps"] // steps <= c * warps, work
    ref = _image(mk.render_frame_plain(params, config, cam, opaque, H, W))
    assert _cloud_ok(_image({"color": color, "alpha": alpha}), ref)


# the work counts of the procedural kernel before its redesign for Hopper (a
# thread per column and coverage group marching its own coarse pixels, two
# opaque passes per pixel), on the 64x128 frames below, as an H100 counted
# them (compare_megakernel.py)
_PARENT_WORK = {"avatar": dict(march=2339, knot_groups=1184, coverage_evals=0, shape_evals=149696),
                "exterior": dict(march=612, knot_groups=327, coverage_evals=0, shape_evals=39168)}


# the texture instance's work counts on the 64x128 texture frame at the
# avatar pose (one 1024-thread block per tile), as an H100 counted them at the
# commit before its registers were sized for two tiles per SM at G = 8
# (compare_megakernel.py)
_PARENT_TEX_WORK = dict(pixels=8192, atmosphere=5024, knot_groups=2048, march=2339, tex3d=0,
                        tex3d_floor=34816, latlong=18432, latlong_floor=0, sky=0, sky_floor=0)


@pytest.mark.cuda
def test_texture_work_counts_equal_the_parents(cuda, baked):
    """The texture instance renders the same work: its pixel, atmosphere,
    knot-group, march and sample counts, which the roofline bound is
    computed from, equal the previous commit's on the same frame."""
    scene, cam = _texture_scene(cuda, baked, "avatar", 4)
    _, params, configs = scene._sorted_layers(cam)
    config, tex = scene._texture_plan(params[0], configs[0])
    struct = mk.frame_constants(params[0], config, cam, scene.opaque, H, W)
    work = mk.work_counts(struct, torch.empty((H, W, 3), device=cuda),
                          torch.empty((H, W), device=cuda), tex=mk._tex_launch(config, tex))
    assert {k: work[k] for k in _PARENT_TEX_WORK} == _PARENT_TEX_WORK


@pytest.mark.cuda
@pytest.mark.parametrize("pose", sorted(_PARENT_WORK))
def test_work_counts_equal_the_parents(cuda, pose):
    """The redesign renders the same work: its march, knot-group, coverage
    and shape counts, which the roofline bound is computed from, equal the
    previous design's on the same frame."""
    params, config, cam, opaque = _inputs("clouds_high", pose, cuda)
    struct = mk.frame_constants(params, config, cam, opaque, H, W)
    work = mk.work_counts(struct, torch.empty((H, W, 3), device=cuda),
                          torch.empty((H, W), device=cuda))
    assert {k: work[k] for k in _PARENT_WORK[pose]} == _PARENT_WORK[pose]


@pytest.mark.cuda
def test_gas_giant_band_matches_plain(cuda):
    """The gas giant's 64-step band at its limb pose (192×128, as in
    ``tests/test_torch_goldens.py``) through the cloud-free instance against
    the plain chain on the same CUDA inputs, under the golden test's budget
    (at most 0.3 % of the pixels off at atol 1e-5 and rtol 1e-4, all on
    rays through the shell), its largest |Δ| at most 5e-4 or, where more,
    twice the largest move of the plain frame itself when the camera's
    position moves by one ulp of its largest coordinate (2.4e-4 at
    z = 3000) along x, y or z, either way, as this test measures first
    (``chip_smoke.gas_giant_ulp_bound``): two frames rounded apart, each
    within one such move of the exact frame.

    The measurement behind it (``chip_smoke.py`` phase 3i, on an H100 80GB
    HBM3 at 700 W): the kernel against the card's plain chain 48 pixels
    off, max 5.71e-4 (2 above 5e-4); against the CPU plain chain 38, max
    4.18e-4; against the JAX XLA frame 52, max 5.41e-4; the three
    references against one another within the golden's budget (max
    4.48e-4).  One ulp of the camera's position moves the card's plain
    frame by up to 5.04e-4 (z-, 86 pixels off), the CPU's by up to 4.89e-4
    (x, 105 off), the kernel's by up to 5.46e-4 (y+): every frame leaves
    the golden's budget on one ulp, the card's plain frame by its max too,
    and the kernel's worst pixel (155, 11) is the CPU frame's most
    ulp-sensitive one on z+.  So the kernel's largest deviations are
    rounding in an ill-conditioned frame (64 steps through optical depths
    up to ~8000), not a fault; its bound there is 2 × 5.04e-4 = 1.01e-3."""
    import chip_smoke as cs

    card = cs.gas_giant_frames(cuda)  # raises unless the cloud-free instance rendered it
    got, ref = card["kernel"], card["plain"]
    conditioning = {cs.ulp_label(move): {"plain_card": cs.limb_deltas(
        cs.gas_giant_frames(cuda, move)["plain"], ref)} for move in cs.ULP_MOVES}
    max_abs, largest = cs.gas_giant_ulp_bound(conditioning)
    assert np.isfinite(got).all() and got[..., 3].max() > 0.5
    st = cs.limb_deltas(got, ref, max_abs)
    assert st["ok"], (st, max_abs, largest)


# the cloud-free instance's work counts on the gas giant's 192x128 band at
# its limb pose, as an H100 counted them at the commit before the empty
# quadrature segment was skipped (compare_megakernel.py); od_segments, which
# that commit did not count, as the kernel that skips it counts them: one
# segment for 0.996 of the 64 steps of each of the 8,752 integrations.  The
# count depends on the compiler's build of the kernel: built by CUDA 12.9's
# nvcc, the kernel before the scene buffer and the kernel with it both count
# 558,016 in one call of compare_megakernel.py (an earlier toolkit's build
# counted 557,958)
_PARENT_GAS_GIANT_WORK = dict(pixels=16384, atmosphere=8752, od_segments=558016)


@pytest.mark.cuda
def test_gas_giant_work_counts_equal_the_parents(cuda):
    """The cloud-free instance renders the same work on the gas giant's
    band: its pixel and atmosphere counts, which the bound is computed from,
    equal the previous commit's; its quadrature segments, at most two per
    step of every integration, equal what the change counted on an H100."""
    from godot_atmosphere_shader_tpu_torch.models.demo import (build_gas_giant_scene,
                                                               gas_giant_camera)

    scene = build_gas_giant_scene(device=cuda)
    cam = gas_giant_camera("limb", device=cuda)
    scene.update(0.5, cam)
    h, w = 192, 128
    params, configs, tex, bands, rows = _plan(scene, cam, h)
    launches = mk.scene_launches(params, configs, cam, scene.opaque, h, w, tex_data=tex,
                                 bands=bands, band_rows=rows)
    color = torch.empty((h, w, 3), device=cuda)
    alpha = torch.empty((h, w), device=cuda)
    depth = torch.empty((h, w), device=cuda)
    for _, struct, args in launches:
        work = mk.work_counts(struct, color, alpha, depth=depth, **args)
    steps = configs[0].atmosphere_steps
    assert steps == 64 and struct.with_atmosphere and not struct.clouds_enabled
    assert 0 < work["od_segments"] <= 2 * steps * work["atmosphere"]
    assert {k: work[k] for k in _PARENT_GAS_GIANT_WORK} == _PARENT_GAS_GIANT_WORK


# -- K1 sized per scene, large worlds, the LUT's route -----------------------------


def _geometry_cases():
    import chip_smoke as cs

    return [(c, i) for c in cs.GEOMETRY_CASES for i in cs.GEOMETRY_INSTANCES]


@pytest.mark.cuda
@pytest.mark.parametrize("case,instance", _geometry_cases())
def test_geometry_and_octaves_past_the_struct_match_plain(cuda, baked, case, instance):
    """Spheres, boxes and octaves past the launch struct's inline 8, 4 and
    8 (read from the scene buffer) through each instance that takes them,
    against the plain chain: cloud-free at atol 1e-5, rtol 1e-4, cloudy
    at the cloud tolerance.  The fields' octave chains are
    ``chip_smoke.GEOMETRY_CHAINS``: with the demo's, one ulp of the camera
    moves these plain frames as far as kernel and plain lie apart
    (``chip_smoke.geometry_conditioning`` measures it)."""
    import chip_smoke as cs

    spheres, boxes, octaves = case
    h, w = cs.GEOMETRY_SIZE
    scene, cam = cs.crowded_scene(instance, spheres, boxes, octaves, cuda, textures=baked)
    assert scene.opaque.sphere_centers.shape[0] == spheres
    mk.counters.reset()
    got = cs.frame_array(scene.render(cam, h, w, renderer="kernel"))
    counts = (mk.counters.general_launches, mk.counters.clear_launches,
              mk.counters.texture_launches - mk.counters.texture_general_launches,
              mk.counters.texture_general_launches)
    want = {"procedural": (1, 0, 0, 0), "cloud-free": (0, 1, 0, 0), "texture": (0, 0, 1, 0),
            "texture general": (0, 0, 0, 1)}[instance]
    assert counts == want and mk.counters.plain_calls == 0
    ref = cs.frame_array(scene.render(cam, h, w, renderer="plain"))
    assert np.isfinite(got).all()
    if instance == "cloud-free":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    else:
        st = cs.cloud_deltas(got, ref)
        assert cs.cloud_tolerance_ok(st), st


@pytest.mark.cuda
def test_scene_buffer_is_on_the_card_and_cached(cuda):
    import chip_smoke as cs

    scene, cam = cs.crowded_scene("procedural", 12, 6, 10, cuda)
    _, params, configs = scene._sorted_layers(cam)
    s = mk.frame_constants(params[0], configs[0], cam, scene.opaque, H, W)
    buf = next(t for _, _, t in mk._SCENE_BUFFERS.values() if t.data_ptr() == s.geom)
    assert buf.is_cuda and s.shape.ext and s.coverage.ext
    assert mk.frame_constants(params[0], configs[0], cam, scene.opaque, H, W).geom == s.geom
    small, cam2 = cs.crowded_scene("procedural", 8, 4, 8, cuda)
    _, params, configs = small._sorted_layers(cam2)
    s = mk.frame_constants(params[0], configs[0], cam2, small.opaque, H, W)
    assert not s.geom and not s.shape.ext and not s.coverage.ext


@pytest.mark.cuda
def test_large_world_through_the_kernel(cuda):
    """The Earth-scale scene at 64×128 through K1, at the origin and
    translated by (3e7, 1e7, −2e7): max |Δ| ≤ 1e-5; without the rebase at
    (2.56e8, 1e8, −1.6e8) the error is more than 10× the rebased one."""
    import chip_smoke as cs

    def frame(offset, large_world=None):
        scene, cam = cs.earth_scene(offset, cuda, large_world)
        mk.counters.reset()
        out = cs.frame_array(scene.render(cam, H, W))
        assert mk.counters.megakernel_launches >= 1 and mk.counters.plain_calls == 0
        return out

    base = frame((0.0, 0.0, 0.0), True)
    assert np.abs(frame(cs.LARGE_OFFSET) - base).max() <= cs.LARGE_WORLD_MAX
    err_lw = np.abs(frame(cs.RAW_OFFSET, True) - base).mean()
    err_raw = np.abs(frame(cs.RAW_OFFSET, False) - base).mean()
    assert err_raw > 10.0 * max(err_lw, 1e-7)


@pytest.mark.cuda
def test_lut_takes_the_plain_route_on_the_card(cuda):
    """``od_mode="lut"``: ``renderer="auto"`` renders the plain chain on the
    card (no K1 launch), within the cloud tolerance of the CPU's frame;
    ``renderer="kernel"`` raises."""
    import chip_smoke as cs

    frames = {}
    for device in (cuda, torch.device("cpu")):
        scene, cam = cs.scene_and_camera("clouds", "avatar", device)
        atmo = scene.atmospheres[0]
        atmo.set_custom_shader(dataclasses.replace(atmo.config, od_mode="lut"))
        mk.counters.reset()
        frames[device.type] = cs.frame_array(scene.render(cam, H, W))
        assert (mk.counters.megakernel_launches, mk.counters.plain_calls) == (0, 1)
        if device.type == "cuda":
            with pytest.raises(ValueError):
                scene.render(cam, H, W, renderer="kernel")
    st = cs.cloud_deltas(frames["cuda"], frames["cpu"])
    assert cs.cloud_tolerance_ok(st), st


# -- the GPU gate and the band-fidelity tool (godot_atmosphere_shader_tpu_torch/tools) ------


@pytest.mark.cuda
@pytest.mark.parametrize("variant,pose", gpu_checks.VARIANT_POSES)
def test_gate_variant_matches_plain(cuda, variant, pose):
    """``gpu_checks.check_variant`` at 64×128: the planned K1 launches, no
    plain call, the gate's bound (or the tolerance one ulp of the camera
    keeps, which the verdict names)."""
    r = gpu_checks.check_variant(variant, pose, H, W, cuda)
    assert r["launches"]["k1"] == r["launches"]["planned"] and r["launches"]["plain"] == 0
    assert r["pass"], r


@pytest.mark.cuda
def test_gate_banded_sampler_matches_plain(cuda):
    """K2 alone on the gate's close-up: the kernel against the plain run on
    the CPU (atol 2e-6, the same mode and level) and against exact
    trilinear (1e-5), banding engaged."""
    r = gpu_checks.check_banded_sampler(cuda)
    assert r["pass"] and r["launches"] == 2, r
    card, plain = gpu_checks.sample_banded(cuda), gpu_checks.sample_banded("cpu")
    for name in ("on", "off"):
        torch.testing.assert_close(card[name].cpu(), plain[name], rtol=0, atol=2e-6)
        assert card[f"{name}_choice"] == plain[f"{name}_choice"]


@pytest.mark.cuda
def test_gate_sharded_band_is_the_whole_frame(cuda):
    r = gpu_checks.check_sharded_band(256, 384, cuda)
    assert r["pass"] and r["band_vs_full_max_delta"] == 0.0, r


@pytest.mark.cuda
def test_gate_main_writes_its_verdict(cuda, tmp_path):
    """The whole gate at its default 256×384: exit 0, every check passing,
    the card's ``nvidia-smi`` name and power limit in the verdict."""
    out = tmp_path / "GPU_CHECKS.json"
    assert gpu_checks.main(["-o", str(out)]) == 0
    verdict = json.loads(out.read_text())
    assert verdict["all_pass"] and len(verdict["results"]) == len(gpu_checks.VARIANT_POSES) + 6
    assert verdict["device"] == gpu_checks.card_name() and "W" in verdict["device"]


@pytest.mark.cuda
def test_band_fidelity_on_the_card(cuda, baked):
    """The band-fidelity tool at the interior pose: K2's choice is the plain
    choice in every one of the 1530 batches, whose pixels all hit there;
    the JAX tool's level counts (PARITY #12: 484 batches at level 0); on
    the first engaged batches K2 within 2e-6 of the plain samplers, and
    banding brings the field error down."""
    geom = bf.batch_geometry("interior", cuda, textures=baked)
    mk.counters.reset()
    fits = bf.run_fits(geom)
    assert fits["k2_same_choice"] == fits["k2_full_batches"] == fits["batches"] == 1530
    assert fits["banded"]["L0(64^3)"] == 484 and fits["windowed"]["floor"] == 1116
    res = bf.run_field_err(geom, 4)
    assert res["engaged_batches"] == 4 and res["k2_vs_plain_same_choice"], res
    assert res["k2_vs_plain_max"] <= 2e-6
    assert res["banded"]["mean"] < res["windowed"]["mean"] / 10
    assert mk.counters.texsample_launches > 0


# -- the program's spans against the device's copies -------------------------------


@pytest.mark.cuda
def test_copy_spans_name_every_transfer(cuda):
    """One flagship frame (a new camera, ``Scene.update``, ``Scene.render``)
    and one 8-frame TAA flight at 1080p under ``torch.profiler``, each call
    inside a ``bench.*`` range as the benchmark's traced run puts it: in each
    unit the copy spans (``port.copy.*``) are as many as the trace's
    host↔device copies, one launch span per launch, every program span
    nests in its unit's ``bench.*`` ranges, and none reaches the device's
    timeline."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from godot_atmosphere_shader_tpu_torch.ops.kernels import taa
    from godot_atmosphere_shader_tpu_torch.utils.camera import Camera
    from godot_atmosphere_shader_tpu_torch.utils.flight import FlyCamera

    h, w, k = 1080, 1920, 8
    scene = build_demo_scene("clouds_high", device=cuda)
    fly = FlyCamera(position=(0.0, 0.0, 156.425))
    poses = []
    for _ in range(k + 1):
        poses.append(fly.view_to_world())
        fly.look(0.002, 0.0).move((0.0, 0.0, -10.0))
    poses = np.stack(poses).astype(np.float32)
    times = 0.5 + np.arange(k) / 60.0

    def frame():
        with record_function("bench.update"):
            cam = Camera.create(poses[0], device=cuda)
            scene.update(float(times[0]), cam)
        with record_function("bench.render"):
            scene.render(cam, h, w)

    def flight():
        with record_function("bench.render_flight"):
            cam = Camera.create(poses[1], device=cuda)
            scene.render_flight(cam, times, h, w, cam_transforms=poses[1:], taa_blend=0.15)

    frame()  # the library's build, the blue-noise tile: once a process
    flight()
    torch.cuda.synchronize()
    mk.counters.reset()
    taa.counters.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        frame()
        torch.cuda.synchronize()
        flight()
        torch.cuda.synchronize()
    on_cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert any("megakernel_gen" in e.name for e in on_card), "the trace holds no K1 launch"
    assert not [e.name for e in on_card if e.name.startswith("port.")]
    program = [e for e in on_cpu if e.name.startswith("port.")]
    for name in {e.name for e in program}:
        assert not any(s in name for s in ("DtoH", "HtoD", "megakernel_gen", "megakernel_clear",
                                           "megakernel_tex", "tex_choice_kernel",
                                           "taa_kernel")), name
    bench = {}
    for e in on_cpu:
        if e.name.startswith("bench."):
            unit = "flight" if e.name == "bench.render_flight" else "frame"
            bench.setdefault(unit, []).append((e.time_range.start, e.time_range.end))
    assert sorted(bench) == ["flight", "frame"] and len(bench["frame"]) == 2

    def inside(e, ranges):
        return any(s <= e.time_range.start and e.time_range.end <= t for s, t in ranges)

    for e in program:
        assert inside(e, bench["frame"]) or inside(e, bench["flight"]), e.name
    counts = {}
    for unit, ranges in bench.items():
        window = [(min(s for s, _ in ranges), max(t for _, t in ranges))]
        copies = [e.name for e in program if e.name.startswith("port.copy.")
                  and inside(e, ranges)]
        memcpy = [e.name for e in on_card if ("HtoD" in e.name or "DtoH" in e.name)
                  and e.time_range.start >= window[0][0]
                  and e.time_range.start <= window[0][1]]
        counts[unit] = (len(copies), len(memcpy), sorted(copies))
        assert copies and len(copies) == len(memcpy), (unit, sorted(copies), memcpy)
    names = [e.name for e in program]
    assert names.count("port.megakernel.launch") == mk.counters.megakernel_launches == 1 + k
    assert names.count("port.taa.launch") == taa.counters.launches == k
    assert names.count("port.megakernel.frame_constants") == 2  # the frame's, the flight's 0
    print(json.dumps(counts))


@pytest.mark.cuda
def test_frame_waits_for_no_copy(cuda):
    """A warmed flagship frame at 1080p (a new camera, ``Scene.update``,
    ``Scene.render``) under ``torch.profiler``, inside the ``bench.*``
    ranges the benchmark puts around it: its preamble reads every tensor
    from its host mirror, so the device makes no device→host copy, and
    inside those ranges the host neither waits for the stream nor
    allocates or frees pinned memory.  What the mirrors hold is what the
    device holds: the frame is bit for bit the one rendered with every
    tensor read by a copy, and the fov the host converted equals the
    device's ``deg2rad``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from godot_atmosphere_shader_tpu_torch.utils import host_mirror
    from godot_atmosphere_shader_tpu_torch.utils.camera import Camera
    from godot_atmosphere_shader_tpu_torch.utils.flight import FlyCamera

    h, w = 1080, 1920
    scene = build_demo_scene("clouds_high", device=cuda)
    fly = FlyCamera(position=(0.0, 0.0, 156.425))
    poses = []
    for _ in range(5):
        poses.append(fly.view_to_world().astype(np.float32))
        fly.look(0.002, 0.0).move((0.0, 0.0, -10.0 / 60.0))

    def frame(i):
        with record_function("bench.update"):
            cam = Camera.create(poses[i], device=cuda)
            scene.update(0.5 + i / 60.0, cam)
        with record_function("bench.render"):
            return cam, scene.render(cam, h, w)

    for i in range(4):  # the library, the blue-noise tile, pinned blocks, the colors' copy
        frame(i)
    torch.cuda.synchronize()
    host_mirror.counters.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cam, out = frame(4)
        torch.cuda.synchronize()
    assert host_mirror.counters.copies == 0 and host_mirror.counters.hits > 0
    on_cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert any("megakernel_gen" in e.name for e in on_card), "the trace holds no K1 launch"
    assert not [e.name for e in on_card if "DtoH" in e.name]
    assert [e.name for e in on_card if "HtoD" in e.name]  # the uploads are still there
    ranges = [(e.time_range.start, e.time_range.end) for e in on_cpu
              if e.name in ("bench.update", "bench.render")]
    assert len(ranges) == 2
    waits = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
             "cudaMemcpy", "cudaHostAlloc", "cudaMallocHost", "cudaFreeHost")
    inside = [e.name for e in prof.events()  # the runtime's calls, on the host's thread
              if any(s <= e.time_range.start <= t for s, t in ranges)]
    assert any(n.startswith("cudaMemcpyAsync") for n in inside)  # the runtime calls are traced
    assert not [n for n in inside if n in waits], sorted(set(inside))
    assert torch.equal(cam.fov_y_rad, torch.deg2rad(torch.tensor(70.0, device=cuda)))
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(host_mirror, "_mirror", lambda t: None)
        copied = scene.render(cam, h, w)
    finally:
        mp.undo()
    assert torch.equal(out["color"], copied["color"]) and torch.equal(out["alpha"], copied["alpha"])
