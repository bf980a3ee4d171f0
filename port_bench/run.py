"""Run one cell of the benchmark once.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (imports, the kernel library's load or
first build, the scene, one warm-up unit of the cell's own shapes) is timed
from the start of the process to the first timed unit.  Then the window:
``--seconds`` of the cell's traffic.  ``--trace 0`` prints the cell's
end-to-end metrics; ``--trace 1`` the per-layer ones, from the same window's
spans and from one ``torch.profiler`` trace of a further
``harness.TRACE_SECONDS``.  Either way a sample of the window's outputs,
drawn from the seed, is compared with the plain reference once the window
has closed (``compare.py``).  The last line of standard output is one JSON
object; the compared numbers and their limits are the last lines of
standard error too.

A run on a machine without the card (or with fewer cards than the cell
asks for) prints no result and exits 2; a run that cannot measure or
compare exits 1.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

#: top-level modules that may not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "godot_atmosphere_shader_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def compare_outputs(units, traffic, rs) -> tuple:
    """The program's kept outputs against the reference's frames (``rs``, the
    reference scene): the seed's sample of units and the last one.  Returns
    ``(reading, frames compared, frames failed)``."""
    import torch

    from . import compare
    from .reference import scene as ref

    chosen = [u for u in units if u.index in traffic.sampled]
    if len(chosen) != len(traffic.sampled):
        raise RuntimeError(f"the window finished {len(units)} units; the seed's sample "
                           f"{traffic.sampled} needs more")
    if traffic.compare_last and units[-1] not in chosen:
        chosen.append(units[-1])
    stats, failed = [], 0
    for u in chosen:
        with torch.no_grad():
            if traffic.mix["mode"] == "flight":
                poses, times = traffic.unit(u.index)
                want = ref.render_flight(rs, poses, times, traffic.height, traffic.width,
                                         traffic.mix["taa"])
                frames = [(compare.rgba(u.out, i), compare.rgba(want, i))
                          for i in range(u.frames)]
            else:
                pose, t = traffic.frame(u.index)
                want = ref.render_frame(rs, pose, t, traffic.height, traffic.width)
                frames = [(compare.rgba(u.out), compare.rgba(want))]
        for got, w in frames:
            st = compare.deltas(got, w)
            stats.append(st)
            failed += not compare.judge(st)
        del want, frames
        u.out = None
    return compare.worst(stats), len(stats), failed


def run(args, device=None, build_program=None, out=sys.stdout, err=sys.stderr) -> int:
    """One run.  ``device``/``build_program``: the CPU dry run's stand-ins
    for the card and the program (tests); on the card both are None."""
    from . import compare, harness
    from .reference import scene as ref
    from .workload import Traffic

    root = os.getcwd()
    bench = harness.load_benchmark(root)
    cell = harness.find_cell(bench, args.workload)
    config = harness.load_config(cell["config"])
    mix = harness.load_traffic(cell["traffic"])
    readers = [(m, harness.load_metric(m["name"]))
               for m in harness.cell_metrics(bench, cell["name"], bool(args.trace))]

    import torch

    on_card = device is None
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"needs {cell['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=err)
            return 2
        device = torch.device("cuda", 0)
    from .program import Program

    program = (build_program or Program)(config, device)
    traffic = Traffic(mix, args.seed)
    clock = harness.Clock(torch) if on_card else harness.CpuClock()

    _warm(program, traffic)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    program.reset_counters()
    setup_s = time.perf_counter() - _T0

    units, window_start, window_end = harness.drive(program, traffic, clock, args.seconds,
                                                    keep=set(traffic.sampled))
    result = harness.Run(cell=cell, config=config, traffic=traffic, setup_s=setup_s,
                         units=units, window_start=window_start, window_end=window_end)
    route = program.route()
    if args.trace:
        result.trace = harness.traced(torch, program, traffic, clock, harness.TRACE_SECONDS,
                                      first=units[-1].index + 1)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"

    kept = [u for u in units if u.out is not None]
    del program, clock
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_cmp = time.perf_counter()
    result.ref_scene = ref.build(config, device=device)
    reading, compared, failed = compare_outputs(kept, traffic, result.ref_scene)
    compare_s = time.perf_counter() - t_cmp
    metrics = {}
    for m, reader in readers:
        value = reader.read(result)
        if value is None:
            print(f"metric {m['name']} found nothing to read in {cell['name']}", file=err)
            return 1
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    route_ok = not on_card or (route["plain_calls"] == 0 and route["k1_launches"] > 0)
    correct = compare.judge(reading) and route_ok
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=err)
        return 1
    checks = {k: {"value": reading[k], "limit": compare.LIMITS[k]} for k in compare.LIMITS}
    line = {"correct": bool(correct), "attempted": sum(u.frames for u in units),
            "failed": int(failed), "metrics": metrics,
            "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                       "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}}
    if result.trace is not None:
        busy = harness.busy_us([(s, e) for _, s, e in result.trace.device]) / 1e6
        line["device"].update(busy_s=busy, window_s=result.trace.wall_s)
        line["breakdown"] = harness.breakdown(result.trace)
    line["notes"] = {"card": power_limit() if on_card else "cpu", "seed_start": traffic.start,
                     "frames_compared": compared, "compare_s": compare_s, "route": route,
                     "units_in_window": len(units), "window_s": result.window_ms / 1e3}
    line["compared"] = checks
    print(f"route {json.dumps(route)}: kernel route held {route_ok}", file=err)
    for k, v in checks.items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=err)
    print(json.dumps(line), file=out)
    return 0


def _warm(program, traffic):
    """The warm-up: one unit of the cell's own shapes, the one before the
    window's first."""
    if traffic.mix["mode"] == "flight":
        poses, times = traffic.unit(-1)
        program.render_flight(program.camera(poses[0]), times, poses, traffic.height,
                              traffic.width, traffic.mix["taa"])
    else:
        pose, t = traffic.frame(-1)
        cam = program.camera(pose)
        program.update(cam, t)
        program.render(cam, traffic.height, traffic.width)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        return run(args)
    except Exception as exc:  # a run that cannot measure prints no result
        import traceback

        traceback.print_exc()
        print(f"run failed: {exc!r}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
