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


def test_peaks_are_the_data_sheet():
    assert peaks.FP32_FLOPS == 67e12
    assert peaks.INT32_OPS == 132 * 64 * 1.98e9
    assert peaks.HBM_BYTES == 3.35e12
    assert np.isclose(peaks.bound_ms(0, 0, 3.35e9), 1.0)
