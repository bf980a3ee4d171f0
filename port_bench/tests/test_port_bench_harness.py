"""The harness on the CPU: its statistics, finding configurations, mixes and
metrics by name, and a dry run of each cell's control flow at a tiny size,
with the port's CPU path (its plain frame) as the program and faults
planted in it."""

import dataclasses
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from port_bench import compare, harness, run
from port_bench.harness import Unit
from port_bench.program import Program
from port_bench.reference import scene as ref
from port_bench.workload import Traffic, loop_poses

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ("demo_clouds_high.fly_loop", "demo_clouds_high_ref.fly_loop",
         "demo_clouds_high.flight8_taa")
#: the configuration of baked textures that ``conftest.py`` adds as a file alone, and its cell
TEX = "demo_clouds_high_tex"
TEX_CELL = f"{TEX}.fly_loop"
#: the dry run's frame: whole TAA tiles rows (8) and columns (128), whole LOD groups
SIZE = (32, 128)
#: a dry run's window on the CPU: the least, which runs one loop of the dry run's
#: six-pose path (three forward, three back: six frames, or three flights of two)
SECONDS = 0.01
#: a seed whose loop starts at the dry run's second pose
SEED = next(s for s in range(2 ** 31, 2 ** 31 + 100) if Traffic(
    {**json.load(open(os.path.join(ROOT, "port_bench", "traffic", "fly_loop.json"))),
     "path": {**json.load(open(os.path.join(ROOT, "port_bench", "traffic", "fly_loop.json")))[
         "path"], "frames_out": 3}, "compare": {"early_frames": 1, "early_samples": 1,
                                                "last": 1}}, s).start == 1)


# -- statistics ------------------------------------------------------------------------


def test_percentile_is_over_every_value():
    assert harness.percentile(list(range(1, 101)), 95.0) == pytest.approx(95.05)
    assert harness.percentile([3.0], 95.0) == 3.0
    with pytest.raises(ValueError):
        harness.percentile([], 95.0)


def _run_of(units, window_end=1.0, mode="frames", k=1):
    traffic = type("T", (), {"mix": {"mode": mode}, "frames_per_unit": k})()
    return harness.Run(cell={}, config={}, traffic=traffic, setup_s=2.5, units=units,
                       window_start=0.0, window_end=window_end)


def test_window_rate_and_tail_count_only_units_done_in_the_window():
    frame_ms = harness.load_metric("frame_ms")
    p95 = harness.load_metric("frame_p95_ms")
    units = [Unit(index=i, frames=1, start=0.01 * i, host_s=0.001, end=0.01 * i + 0.02)
             for i in range(100)]  # the last two end after the window
    r = _run_of(units, window_end=1.0)
    assert len(r.done()) == 99
    assert frame_ms.read(r) == pytest.approx(1000.0 / 99)
    assert p95.read(r) == pytest.approx(20.0)
    assert harness.load_metric("frame_p95_ms.host_paced").read(r) == p95.read(r)
    flight = harness.load_metric("flight_frame_ms")
    assert flight.read(r) is None
    r = _run_of([Unit(index=i, frames=8, start=0.1 * i, host_s=0.01, end=0.1 * i + 0.05)
                 for i in range(10)], mode="flight", k=8)
    assert flight.read(r) == pytest.approx(1000.0 / 80)
    assert frame_ms.read(r) is None


def test_busy_is_the_union_of_device_intervals():
    assert harness.busy_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert harness.busy_us([]) == 0
    assert harness.idle_gaps([(0, 10), (5, 15), (20, 30)], 0, 40) == [(15, 20), (30, 40)]


def test_trace_readers_fail_where_no_kernel_matches():
    """A traced run with no kernel of a metric's names reads nothing (the run
    then fails), never 0."""
    t = harness.Trace(device=[("Memcpy DtoH", 0.0, 1.0)], spans=[], units=[
        Unit(index=0, frames=8, start=0, host_s=0)], wall_s=1.0, lo_us=0.0, hi_us=1.0)
    r = _run_of([], mode="flight", k=8)
    r.trace = t
    r.traffic.height, r.traffic.width = 1080, 1920
    for name in ("k1_device_ms.flight", "k3_roofline.flight"):
        assert harness.load_metric(name).read(r) is None
    r = _run_of([])
    r.trace = t
    assert harness.load_metric("k1_roofline.frames").read(r) is None
    assert harness.load_metric("d2h_copies.frames").read(r) == 1.0 / 8


# -- finding things by name ----------------------------------------------------------


def test_a_new_config_mix_or_metric_is_found_as_a_new_file(tmp_path):
    base = tmp_path / "bench"
    shutil.copytree(os.path.join(ROOT, "port_bench"), base, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    cfg = json.load(open(base / "configs" / "demo_clouds_high.json"))
    cfg["name"] = "demo_clouds_high_k4"
    cfg["overrides"] = {"cloud_coverage_knots": 4}
    json.dump(cfg, open(base / "configs" / "demo_clouds_high_k4.json", "w"))
    mix = json.load(open(base / "traffic" / "fly_loop.json"))
    mix["in_flight"] = 3
    json.dump(mix, open(base / "traffic" / "fly_loop3.json", "w"))
    (base / "metrics" / "units.frames.py").write_text("def read(run):\n    return len(run.units)\n")
    assert harness.load_config("demo_clouds_high_k4", str(base))["overrides"] == {
        "cloud_coverage_knots": 4}
    assert harness.load_traffic("fly_loop3", str(base))["in_flight"] == 3
    assert harness.load_metric("units.frames", str(base)).read(_run_of([1, 2])) == 2
    assert ref.variant(harness.load_config("demo_clouds_high_k4", str(base))
                       ).cloud_coverage_knots == 4
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["workloads"].append({"name": "demo_clouds_high_k4.fly_loop3", "config":
                               "demo_clouds_high_k4", "traffic": "fly_loop3", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "units.frames", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "Device", "moves":
                               "frame_ms", "workloads": ["demo_clouds_high_k4.fly_loop3"]})
    cell = harness.find_cell(bench, "demo_clouds_high_k4.fly_loop3")
    assert [m["name"] for m in harness.cell_metrics(bench, cell["name"], True)] == [
        "units.frames"]


@pytest.mark.parametrize("what,name", [("config", "nope"), ("traffic", "nope"),
                                       ("metric", "nope"), ("metric", "../run"),
                                       ("config", "")])
def test_an_unknown_name_is_refused(what, name):
    load = {"config": harness.load_config, "traffic": harness.load_traffic,
            "metric": harness.load_metric}[what]
    with pytest.raises(harness.Refused):
        load(name)
    with pytest.raises(harness.Refused):
        harness.find_cell(json.load(open(os.path.join(ROOT, "BENCHMARK.json"))), "nope.fly")


def test_every_entry_of_the_manifest_has_its_files():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for c in bench["configs"]:
        assert harness.load_config(c["name"])["name"] == c["name"]
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        harness.load_traffic(w["traffic"])
        assert w["config"] + "." + w["traffic"] == w["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        harness.load_metric(m["name"])


def test_the_config_file_holds_the_variant_the_program_runs():
    for name in ("demo_clouds_high", "demo_clouds_high_ref"):
        config = harness.load_config(name)
        program = Program(config, "cpu")
        got = dataclasses.asdict(program.scene.atmospheres[0].config)
        assert got == dataclasses.asdict(ref.variant(config))


def test_the_loop_is_closed_and_the_seed_only_moves_its_start():
    mix = harness.load_traffic("fly_loop")
    poses = loop_poses(mix["path"])
    assert poses.shape == (480, 4, 4)
    assert (poses[0] == poses[-1]).all() and (poses[239] == poses[240]).all()
    assert poses[0][2, 3] == pytest.approx(156.425)
    assert np.linalg.norm(poses[239][:3, 3]) < 120.0
    a, b = Traffic(mix, 1), Traffic(mix, 2 ** 31 + 12345)
    assert 0 <= b.start < 480
    assert (a.frame(480 - a.start)[0] == poses[0]).all()
    assert a.frame(1)[1] - a.frame(0)[1] == pytest.approx(1 / 60)


# -- the dry run -------------------------------------------------------------------------


def _small(monkeypatch, flight_frames=2, root=ROOT):
    real = harness.load_traffic

    def load(name, base=harness.HERE):
        mix = real(name, base)
        mix["height"], mix["width"] = SIZE
        mix["path"]["frames_out"] = 3
        mix["compare"]["early_frames"] = 1
        if "flight_frames" in mix:
            mix["flight_frames"] = flight_frames
        return mix

    monkeypatch.setattr(harness, "load_traffic", load)
    monkeypatch.chdir(root)


def _dry(cell, monkeypatch, program=Program, seed=SEED, root=ROOT):
    torch.set_num_threads(2)
    _small(monkeypatch, root=root)
    out, err = io.StringIO(), io.StringIO()
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(SECONDS),
                      "--trace", "0"])
    rc = run.run(args, device=torch.device("cpu"), build_program=program, out=out, err=err)
    return rc, out.getvalue(), err.getvalue()


def _root(name, request) -> str:
    """The checkout a cell or configuration runs in: the texture
    configuration's, added as a file alone (``conftest.py``), or the repo."""
    return request.getfixturevalue("tex_checkout") if TEX in name else ROOT


@pytest.mark.parametrize("cell", CELLS + (TEX_CELL,))
def test_a_cell_runs_on_the_cpu_and_matches_the_reference(cell, monkeypatch, request):
    """Each cell, and a configuration of baked textures added as a file
    alone: the reference (baking the textures itself) gives the port's plain
    frame to the last bit."""
    rc, out, err = _dry(cell, monkeypatch, root=_root(cell, request))
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert list(line)[-1] == "compared"
    assert line["compared"]["p999"]["value"] == 0.0
    manifest = harness.load_benchmark(_root(cell, request))
    want = {m["name"] for m in harness.cell_metrics(manifest, cell, False)}
    assert want >= {"setup_s", "flight_frame_ms" if "flight" in cell else "frame_ms"}
    assert set(line["metrics"]) == want
    assert err.strip().splitlines()[-1].startswith("compared mean")


class _Stale(Program):
    """A step that returns its state unchanged: after the warm-up's,
    ``Scene.update`` does nothing and every frame renders the warm-up's
    camera; a flight renders every frame at its first frame's state."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.first = None

    def update(self, camera, time_s):
        if self.first is None:
            self.first = camera
            super().update(camera, time_s)

    def render(self, camera, height, width):
        return super().render(self.first, height, width)

    def render_flight(self, camera, times, poses, height, width, taa):
        return super().render_flight(camera, times[:1].repeat(len(times)),
                                     poses[:1].repeat(len(poses), axis=0), height, width, taa)


class _Half(Program):
    """Half of the batch left out: a frame's lower half of rows not
    rendered; a flight's second half of frames copies of its first half."""

    def render(self, camera, height, width):
        out = super().render(camera, height, width)
        out["color"][height // 2:] = 0.0
        out["alpha"][height // 2:] = 0.0
        return out

    def render_flight(self, camera, times, poses, height, width, taa):
        out = super().render_flight(camera, times, poses, height, width, taa)
        k = len(times) // 2
        for key in ("color", "alpha"):
            out[key][k:] = out[key][:len(times) - k]
        return out


class _Altered(Program):
    """An answer altered where it is produced: one 32×128 tile of the frame
    (every frame of a flight) brightened by 0.05."""

    def render(self, camera, height, width):
        out = super().render(camera, height, width)
        out["color"][:32, :128] += 0.05
        return out

    def render_flight(self, camera, times, poses, height, width, taa):
        out = super().render_flight(camera, times, poses, height, width, taa)
        out["color"][:, :32, :128] += 0.05
        return out


@pytest.mark.parametrize("fault", [_Stale, _Half, _Altered])
@pytest.mark.parametrize("cell", [CELLS[0], CELLS[2], TEX_CELL])
def test_a_fault_in_the_timed_path_comes_out_not_correct(cell, fault, monkeypatch, request):
    rc, out, err = _dry(cell, monkeypatch, program=fault, root=_root(cell, request))
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False and line["failed"] >= 1


def test_calibration_takes_a_config_and_a_mix_with_no_cell(tex_checkout, monkeypatch):
    """``calibrate --config --traffic`` finds both by name before it looks for
    the card, a pair with no cell in ``BENCHMARK.json`` included; an unknown
    name is refused, and ``--config`` wants ``--traffic``."""
    from port_bench import calibrate

    monkeypatch.chdir(tex_checkout)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert calibrate.main(["--config", TEX, "--traffic", "fly_loop", "--seeds", "1"]) == 2
    assert calibrate.main(["--workload", CELLS[0], "--seeds", "1"]) == 2
    with pytest.raises(harness.Refused):
        calibrate.main(["--config", "nope", "--traffic", "fly_loop", "--seeds", "1"])
    with pytest.raises(SystemExit):
        calibrate.main(["--config", TEX, "--seeds", "1"])


@pytest.mark.parametrize("name", ["demo_clouds_high", "demo_clouds_high_ref", TEX])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails_the_limits(name, seed, request):
    """The control, the reference's frame in bfloat16, against the reference:
    not correct (at a tiny size; on the card at the cell's size, PERF.md)."""
    torch.set_num_threads(2)
    if name == TEX:
        request.getfixturevalue("tex_checkout")
    config = harness.load_config(name)
    scene = ref.build(config, device="cpu")
    traffic = Traffic(harness.load_traffic("fly_loop"), seed)
    pose, t = traffic.frame(0)
    want = ref.render_frame(scene, pose, t, *SIZE)
    reading = compare.deltas(compare.rgba(compare.control(want)), compare.rgba(want))
    assert not compare.judge(reading)
    assert compare.judge(compare.deltas(compare.rgba(want), compare.rgba(want)))
