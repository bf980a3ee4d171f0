"""The readings that the limits of ``compare.py`` are set from: for each
seed, a short window of the cell's own traffic through the program, its
kept outputs against the reference (the lower reading), and the control, the
reference's frames in bfloat16, against the same reference (the upper).
One process for all seeds; the benchmark's own runs never run this.

    python3 -m port_bench.calibrate --workload <cell> --seeds 1 2 3 ... --seconds 2 [-o out.jsonl]

or, for a pair that ``BENCHMARK.json`` has no cell of yet (a configuration
file and a mix file, found by name), ``--config <name> --traffic <name>``
in place of ``--workload``.
"""

from __future__ import annotations

import argparse
import json
import sys

#: the first seeds, which also read the control
CONTROL_SEEDS = 3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    what = p.add_mutually_exclusive_group(required=True)
    what.add_argument("--workload")
    what.add_argument("--config")
    p.add_argument("--traffic")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("-o", "--output", default=None)
    args = p.parse_args(argv)
    if (args.config is None) != (args.traffic is None):
        p.error("--config and --traffic go together, in place of --workload")

    import os

    import torch

    from . import compare, harness
    from .program import Program
    from .reference import scene as ref
    from .workload import Traffic

    if args.workload is not None:
        cell = harness.find_cell(harness.load_benchmark(os.getcwd()), args.workload)
    else:
        cell = {"name": f"{args.config}.{args.traffic}", "config": args.config,
                "traffic": args.traffic}
    config = harness.load_config(cell["config"])
    mix = harness.load_traffic(cell["traffic"])
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
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
