"""The readings that the limits of ``compare.py`` are set from: for each
seed, a short window of the cell's own traffic through the program, its
kept outputs against the reference (the lower reading), and the control, the
reference's frames in bfloat16, against the same reference (the upper).
One process for all seeds; the benchmark's own runs never run this.

    python3 -m port_bench.calibrate --workload <cell> --seeds 1 2 3 ... --seconds 2 [-o out.jsonl]
"""

from __future__ import annotations

import argparse
import json
import sys

#: the first seeds, which also read the control
CONTROL_SEEDS = 3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("-o", "--output", default=None)
    args = p.parse_args(argv)

    import os

    import torch

    from . import compare, harness
    from .program import Program
    from .reference import scene as ref
    from .workload import Traffic

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_benchmark(os.getcwd())
    cell = harness.find_cell(bench, args.workload)
    config = harness.load_config(cell["config"])
    mix = harness.load_traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    program = Program(config, device)
    rs = ref.build(config, device=device)
    clock = harness.Clock(torch)
    out = open(args.output, "a") if args.output else None
    for n, seed in enumerate(args.seeds):
        traffic = Traffic(mix, seed)
        units, _, _ = harness.drive(program, traffic, clock, args.seconds,
                                    keep=set(traffic.sampled), whole_periods=False)
        kept = [u for u in units if u.out is not None]
        for u in kept:
            with torch.no_grad():
                if mix["mode"] == "flight":
                    poses, times = traffic.unit(u.index)
                    want = ref.render_flight(rs, poses, times, traffic.height, traffic.width,
                                             mix["taa"])
                    idx = list(range(u.frames))
                else:
                    pose, t = traffic.frame(u.index)
                    want = ref.render_frame(rs, pose, t, traffic.height, traffic.width)
                    idx = [None]
            ctl = compare.control(want) if n < CONTROL_SEEDS else None
            for i in idx:
                w = compare.rgba(want, i)
                row = {"workload": cell["name"], "seed": seed, "unit": u.index, "frame": i,
                       "program": compare.deltas(compare.rgba(u.out, i), w)}
                if ctl is not None:
                    row["control"] = compare.deltas(compare.rgba(ctl, i), w)
                line = json.dumps(row)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
            u.out = None
            del want, ctl
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
