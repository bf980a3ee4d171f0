"""The program-span reductions (``port_bench/program_spans.py``) on
hand-made traces: counts, waits, idle overlap and the innermost-span table,
and nothing read where the trace holds no program span; and, on the card,
the tool on one cell."""

import json
import os
import subprocess
import sys

import pytest

from port_bench import harness
from port_bench import program_spans as ps

#: two frames of a hand-made trace, in µs: the device runs K1 at [100, 300) and
#: [700, 900); the host's spans around it, as the port names them
DEVICE = [("megakernel_gen<2>", 100.0, 300.0), ("Memcpy DtoH (Device -> Pageable)", 300.0, 301.0),
          ("megakernel_gen<2>", 700.0, 900.0)]
PROGRAM = [
    ("port.scene.update", 0.0, 60.0),
    ("port.copy.cam_host", 10.0, 40.0),
    ("port.scene.render", 60.0, 110.0),
    ("port.megakernel.frame_constants", 65.0, 95.0),
    ("port.copy.params", 70.0, 80.0),
    ("port.megakernel.launch", 95.0, 100.0),
    ("port.scene.update", 400.0, 600.0),
    ("port.copy.cam_host", 410.0, 590.0),
    ("port.scene.render", 600.0, 700.0),
]
SPANS = [("bench.update", 0.0, 60.0), ("bench.render", 60.0, 110.0),
         ("bench.update", 400.0, 600.0), ("bench.render", 600.0, 700.0)]
LO, HI = 0.0, 1000.0


def test_innermost_names_each_piece_by_its_deepest_span():
    pieces = ps.innermost(PROGRAM[:6])
    assert pieces == [(0.0, 10.0, "port.scene.update"), (10.0, 40.0, "port.copy.cam_host"),
                      (40.0, 60.0, "port.scene.update"), (60.0, 65.0, "port.scene.render"),
                      (65.0, 70.0, "port.megakernel.frame_constants"),
                      (70.0, 80.0, "port.copy.params"),
                      (80.0, 95.0, "port.megakernel.frame_constants"),
                      (95.0, 100.0, "port.megakernel.launch"),
                      (100.0, 110.0, "port.scene.render")]
    # the pieces tile the union of the ranges exactly
    assert sum(e - s for s, e, _ in pieces) == 110.0


def test_innermost_leaves_out_time_outside_every_span():
    assert ps.innermost([("a", 0.0, 1.0), ("b", 5.0, 6.0)]) == [(0.0, 1.0, "a"), (5.0, 6.0, "b")]
    assert ps.innermost([]) == []


def test_copies_waits_and_idle_per_frame():
    assert ps.sync_copies(PROGRAM, 2) == 1.5
    assert ps.copy_wait_ms(PROGRAM, 2) == pytest.approx((30 + 10 + 180) / 1e3 / 2)
    # idle gaps in [0, 1000]: [0, 100), [301, 700), [900, 1000); the program's spans cover
    # [0, 110) and [400, 700): idle inside them 100 + 300
    assert harness.idle_gaps([(s, e) for _, s, e in DEVICE], LO, HI) == [
        (0.0, 100.0), (301.0, 700.0), (900.0, 1000.0)]
    assert ps.idle_preamble_ms(DEVICE, PROGRAM, LO, HI, 2) == pytest.approx(400 / 1e3 / 2)


def test_by_span_splits_host_and_idle_time_by_innermost_span():
    rows = ps.by_span(DEVICE, PROGRAM, LO, HI, 2)
    assert rows["port.copy.cam_host"] == pytest.approx({"self_ms": 0.105, "idle_ms": 0.105})
    assert rows["port.scene.update"] == pytest.approx({"self_ms": 0.025, "idle_ms": 0.025})
    assert rows["port.scene.render"] == pytest.approx({"self_ms": 0.0575, "idle_ms": 0.0525})
    assert rows["port.megakernel.launch"] == pytest.approx({"self_ms": 0.0025, "idle_ms": 0.0025})
    assert list(rows)[0] == "port.copy.cam_host"  # largest idle first
    # every host µs in a span is some span's own, and so is every idle µs inside one
    assert sum(r["self_ms"] for r in rows.values()) == pytest.approx((110 + 300) / 1e3 / 2)
    assert sum(r["idle_ms"] for r in rows.values()) == pytest.approx(
        ps.idle_preamble_ms(DEVICE, PROGRAM, LO, HI, 2))


def test_nothing_read_without_a_program_span():
    for program in ([], [("port.copy.cam_host", 0.0, 1.0)]):
        assert ps.sync_copies(program, 2) is None
        assert ps.copy_wait_ms(program, 2) is None
        assert ps.idle_preamble_ms(DEVICE, program, LO, HI, 2) is None
        assert ps.by_span(DEVICE, program, LO, HI, 2) is None
    assert ps.sync_copies(PROGRAM, 0) is None


def test_nesting_in_the_benchmark_spans():
    assert ps.nested_in_bench(PROGRAM, SPANS)
    assert not ps.nested_in_bench(PROGRAM + [("port.scene.render", 650.0, 720.0)], SPANS)


def test_merged_and_shared():
    assert ps.merged([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]
    assert ps.shared_us([(0, 10), (10, 20), (30, 40)], [(5, 15), (35, 100)]) == [5, 5, 5]


@pytest.mark.cuda
def test_the_span_tool_on_the_card():
    """One short run of the tool on the flagship loop: every device copy has
    its copy span, every program span nests in a ``bench.*`` span, none
    reaches the device's timeline (so the accepted readers' ``Trace.device``
    holds none), and each number reads."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-m", "port_bench.program_spans", "--workload",
                          "demo_clouds_high.fly_loop", "--seed", "2718281828", "--seconds", "1"],
                         cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["copies_named"] is True and line["nested_in_bench"] is True
    assert line["device_mirrors"] == 0
    assert line["sync_copies"] == line["memcpy_events_per_frame"] > 0
    assert 0 < line["copy_wait_ms"] and 0 < line["idle_preamble_ms"]
    assert "port.megakernel.frame_constants" in line["by_span"]
