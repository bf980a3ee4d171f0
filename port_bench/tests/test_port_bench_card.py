"""The benchmark on the card: one short run of each cell, correct, with every
metric it owes.  Skips without a card (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_cell_runs_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", cell, "--seed",
                          "3141592653", "--seconds", "1", "--trace", str(trace)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    entries = BENCH["per_layer"] if trace else BENCH["end_to_end"]
    want = {m["name"] for m in entries if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
