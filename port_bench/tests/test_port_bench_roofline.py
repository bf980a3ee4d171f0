"""The roofline files: the frozen counts give what the repo's
``chip_smoke.py`` gives with its peaks at the data sheet's, K1's march
count from geometry equals the count the reference itself marches, and
K3's bound follows the pixel count."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.reference import clouds as ref_clouds
from port_bench.reference import scene as ref
from port_bench.reference import texsample
from port_bench.roofline import counts, k1_work, k3, peaks
from port_bench.workload import Traffic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORK = {"pixels": 2073600, "atmosphere": 1500000, "od_segments": 17000000, "knot_groups": 400000,
        "march": 700000, "tex3d": 11, "tex3d_floor": 12, "latlong": 13, "latlong_floor": 14,
        "sun_samples": 15, "v1_atmosphere": 16, "opaque_pixels": 17, "sky": 18, "sky_floor": 19,
        "coverage_evals": 20, "shape_evals": 44800000, "detail_evals": 21, "shape_knots": 22,
        "detail_knots": 23}


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


@pytest.mark.parametrize("name", ["demo_clouds_high", "demo_clouds_high_ref"])
def test_counts_equal_chip_smoke_at_the_data_sheet(name, chip_smoke, monkeypatch):
    config = ref.variant(harness.load_config(name))
    assert counts.work_ops(WORK, config) == chip_smoke.work_ops(WORK, config)
    monkeypatch.setattr(chip_smoke, "PEAK", {"fp32": peaks.FP32_FLOPS, "int32": peaks.INT32_OPS})
    ops = counts.work_ops(WORK, config)
    fp = ops["shade"] + ops["blend"] + ops["clouds"]
    assert peaks.ops_time_ms(fp, ops["int_ops"]) == chip_smoke.ops_time_ms(fp, ops["int_ops"])
    assert chip_smoke.PEAK_BYTES == peaks.HBM_BYTES
    want = chip_smoke.roofline(WORK, config, 1080, 1920)["bound_ms"]
    assert k1_work.frame_bound_ms(WORK, config, 1080, 1920) == pytest.approx(want, rel=1e-12)


def test_k3_bound_by_the_pixel_count(chip_smoke):
    b = k3.resolve_bound_ms(1080, 1920)
    assert b == pytest.approx(1080 * 1920 * chip_smoke.BYTES_TAA_PIXEL / 3.35e12 * 1e3)
    assert k3.resolve_bound_ms(540, 1920) == pytest.approx(b / 2)


def _reference_marches(scene, pose, time_s, h, w, monkeypatch) -> int:
    """Render the reference frame and count the coarse pixels its march
    runs on: visible, with a positive density bound where knots cull."""
    seen = {}
    real_march = ref_clouds.raymarch_cloud
    real_bound = ref_clouds.cull_bound

    def march(ro, rd, t_begin, t_end, *a, **kw):
        seen["span"] = t_end > t_begin
        return real_march(ro, rd, t_begin, t_end, *a, **kw)

    def bound(*a, **kw):
        seen["bound"] = real_bound(*a, **kw)
        return seen["bound"]

    monkeypatch.setattr(ref_clouds, "raymarch_cloud", march)
    monkeypatch.setattr(ref_clouds, "cull_bound", bound)
    ref.render_frame(scene, pose, time_s, h, w)
    marching = seen["span"]
    if "bound" in seen:
        marching = marching & (seen["bound"] > 0.0)
    return int(marching.sum())


@pytest.mark.parametrize("name", ["demo_clouds_high", "demo_clouds_high_ref"])
@pytest.mark.parametrize("frame", [0, 150])
def test_march_count_from_geometry_equals_the_references(name, frame, monkeypatch):
    torch.set_num_threads(2)
    config = harness.load_config(name)
    scene = ref.build(config, device="cpu")
    traffic = Traffic(harness.load_traffic("fly_loop"), seed=0)
    pose, t = traffic.frame(frame)
    work = k1_work.frame_work(scene, pose, t, 64, 128)
    assert work["march"] == _reference_marches(scene, pose, t, 64, 128, monkeypatch)
    assert 0 < work["march"] < 64 * 128
    assert work["pixels"] == 64 * 128
    assert 0 < work["atmosphere"] <= work["pixels"]
    n = scene.config.atmosphere_steps
    assert 0 < work["od_segments"] <= 2 * n * work["atmosphere"]
    if scene.config.cloud_coverage_interp:
        assert work["coverage_evals"] == 0 and work["knot_groups"] > 0
    else:
        assert work["coverage_evals"] == work["march"] * scene.config.cloud_steps


#: ``frame_work``'s units (those not 0) on the loop's frames 0, 150 and 300
#: (seed 0) at 64×128, and on frame 150 at 1080×1920, as the parent of the
#: texture units reckoned them: the procedural units may not move unseen
PINNED = {
    ("demo_clouds_high", 64, 0): dict(atmosphere=5834, od_segments=43462, knot_groups=1364,
                                       march=2702, shape_evals=172928),
    ("demo_clouds_high", 64, 150): dict(atmosphere=6198, od_segments=46134, knot_groups=1512,
                                         march=3008, shape_evals=192512),
    ("demo_clouds_high", 64, 300): dict(atmosphere=5948, od_segments=44140, knot_groups=1426,
                                         march=2848, shape_evals=182272),
    ("demo_clouds_high_ref", 64, 0): dict(atmosphere=5834, od_segments=43462, march=5397,
                                           coverage_evals=345408, shape_evals=345408),
    ("demo_clouds_high_ref", 64, 150): dict(atmosphere=6198, od_segments=46134, march=6016,
                                             coverage_evals=385024, shape_evals=385024),
    ("demo_clouds_high_ref", 64, 300): dict(atmosphere=5948, od_segments=44140, march=5694,
                                             coverage_evals=364416, shape_evals=364416),
    ("demo_clouds_high", 1080, 150): dict(atmosphere=1636150, od_segments=12192007,
                                           knot_groups=396230, march=792278,
                                           shape_evals=50705792),
    ("demo_clouds_high_ref", 1080, 150): dict(atmosphere=1636150, od_segments=12192007,
                                               march=1584600, coverage_evals=101414400,
                                               shape_evals=101414400),
}


@pytest.mark.parametrize("name,height,frame", list(PINNED))
def test_procedural_units_are_pinned(name, height, frame):
    torch.set_num_threads(2)
    width = height * 2 if height == 64 else 1920
    scene = ref.build(harness.load_config(name), device="cpu")
    pose, t = Traffic(harness.load_traffic("fly_loop"), seed=0).frame(frame)
    work = k1_work.frame_work(scene, pose, t, height, width)
    assert {k: v for k, v in work.items() if v} == {"pixels": height * width,
                                                     **PINNED[name, height, frame]}


def _reference_tex_units(scene, pose, time_s, h, w, monkeypatch) -> dict:
    """Render the reference frame of a baked layer and count its texture
    units from what it did: each knot sampler call's per-tile choices
    (``record_batch_choices``) over the tiles that its coarse pixels'
    visibility lets sample, ``texture_knot_group`` knots a call of each
    field's K + 1 (coverage's calls first)."""
    seen = {}
    real = ref_clouds.render_clouds

    def clouds(*a, **kw):
        out = real(*a, **kw)
        seen["visible"] = out[2]
        return out

    monkeypatch.setattr(ref_clouds, "render_clouds", clouds)
    with texsample.record_batch_choices() as calls:
        ref.render_frame(scene, pose, time_s, h, w)
    c = scene.config
    tile_rows = 32 // c.cloud_lod
    vis = seen["visible"]
    tiles = vis.reshape(vis.shape[0] // tile_rows, tile_rows, vis.shape[1] // 128, 128)
    tile_vis = tiles.any(dim=3).any(dim=1).reshape(-1)
    groups = 32 // (c.cloud_lod * c.cloud_coverage_lod) * 128
    step = c.texture_knot_group
    sizes = [("latlong", min(step, c.cloud_coverage_knots + 1 - j))
             for j in range(0, c.cloud_coverage_knots + 1, step)]
    sizes += [("tex3d", min(step, c.cloud_shape_knots + 1 - j))
              for j in range(0, c.cloud_shape_knots + 1, step)]
    assert len(calls) == len(sizes)
    units = {"knot_groups": int(tile_vis.sum()) * groups, "tex3d": 0, "tex3d_floor": 0,
             "latlong": 0, "latlong_floor": 0}
    for (slot, knots), (mode, _) in zip(sizes, calls):
        floor = mode == texsample.FLOOR
        units[slot] += knots * groups * int((tile_vis & ~floor).sum())
        units[slot + "_floor"] += knots * groups * int((tile_vis & floor).sum())
    return units


@pytest.mark.parametrize("frame", [0, 150])
def test_texture_units_are_the_reference_samplers_choices(frame, tex_checkout, monkeypatch):
    """A baked layer at 48×128 (two tiles, the second half padding): its
    texture units and knot groups are those the reference's own samplers
    chose at the frame's knots, its march the coarse pixels the reference
    marches (padding included), and its bound adds the tables' bytes."""
    torch.set_num_threads(2)
    scene = ref.build(harness.load_config("demo_clouds_high_tex"), device="cpu")
    c = scene.config
    assert c.cloud_shape_interp and c.cloud_coverage_interp
    assert [(m.rows, 128) for m in (c.cloud_shape_tex_meta, c.cloud_coverage_tex_meta)] == [
        tuple(t.shape) for t in scene.tex_data]
    pose, t = Traffic(harness.load_traffic("fly_loop"), seed=0).frame(frame)
    work = k1_work.frame_work(scene, pose, t, 48, 128)
    want = _reference_tex_units(scene, pose, t, 48, 128, monkeypatch)
    assert {k: work[k] for k in want} == want
    assert want["tex3d"] + want["tex3d_floor"] == want["knot_groups"] * 17 > 0
    assert want["latlong"] + want["latlong_floor"] == want["knot_groups"] * 9
    assert work["march"] == _reference_marches(scene, pose, t, 48, 128, monkeypatch)
    assert work["pixels"] == 48 * 128 and work["shape_evals"] == work["coverage_evals"] == 0
    assert 0 < work["atmosphere"] <= 48 * 128
    tables = sum(m.rows * 128 * 4 for m in (scene.config.cloud_shape_tex_meta,
                                             scene.config.cloud_coverage_tex_meta))
    bound = k1_work.frame_bound_ms(work, scene.config, 48, 128)
    assert bound == pytest.approx(max(peaks.ops_time_ms(
        sum(v for k, v in counts.work_ops(work, scene.config).items() if k != "int_ops")),
        (48 * 128 * 16 + k1_work.BLUE_NOISE_BYTES + tables) / peaks.HBM_BYTES * 1e3))


def test_od_segments_of_simple_chords():
    """A sample above the ground facing away from it: one segment; facing
    through the planet: two; on the far side of a miss: one."""
    from port_bench.reference.vecmath import Vec3

    c = Vec3(torch.tensor(0.0), torch.tensor(0.0), torch.tensor(0.0))
    pos = Vec3(torch.tensor([0.0, 0.0]), torch.tensor([104.0, 104.0]), torch.tensor([0.0, 0.0]))
    sun = Vec3(torch.tensor([0.0, 0.0]), torch.tensor([1.0, -1.0]), torch.tensor([0.0, 0.0]))
    segs = k1_work.od_segments(pos, sun, c, torch.tensor(100.0), torch.tensor(108.0))
    assert segs.tolist() == [1, 2]


def test_a_work_vector_is_never_read_from_the_kernels():
    """No file of the yardstick names the kernels' work counters."""
    for f in os.listdir(os.path.join(ROOT, "port_bench", "roofline")):
        if f.endswith(".py"):
            src = open(os.path.join(ROOT, "port_bench", "roofline", f)).read()
            assert "work_counts" not in src.replace("``work_counts``", "")
    for f in os.listdir(os.path.join(ROOT, "port_bench", "metrics")):
        assert "work_counts" not in open(os.path.join(ROOT, "port_bench", "metrics", f)).read()


def test_k1_units_refuse_unreckoned_configs():
    config = ref.variant(harness.load_config("demo_clouds_high"))
    with pytest.raises(ValueError):
        k1_work.check_config(dataclasses.replace(config, raymarched_lighting=True))
    with pytest.raises(ValueError):
        k1_work.check_config(dataclasses.replace(config, cloud_shape_interp=True))
    meta = texsample.TexMeta(kind="tex3d", levels=((8, 0),), rows=68)
    baked = dataclasses.replace(config, cloud_shape_noise=None, cloud_coverage_noise=None,
                                cloud_shape_tex_meta=meta, cloud_coverage_tex_meta=meta,
                                cloud_shape_interp=True)
    k1_work.check_config(baked)
    for change in (dict(cloud_coverage_knots=4), dict(cloud_shape_knots=8),
                   dict(cloud_lod=1, cloud_coverage_lod=1), dict(cloud_shape_tex_meta=None),
                   dict(clouds_always_low_quality=False), dict(raymarched_lighting=True)):
        with pytest.raises(ValueError):
            k1_work.check_config(dataclasses.replace(baked, **change))


def test_peaks_are_the_data_sheet():
    assert peaks.FP32_FLOPS == 67e12
    assert peaks.INT32_OPS == 132 * 64 * 1.98e9
    assert peaks.HBM_BYTES == 3.35e12
    assert np.isclose(peaks.bound_ms(0, 0, 3.35e9), 1.0)
