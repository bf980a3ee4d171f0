"""The program's own spans in a traced window: what the host does while the
device idles, by the port's functions.

The port names its host preamble with spans (``port.<module>.<function>``)
and each copy between the host and the card (``port.copy.<site>``), CPU
ranges of the ``torch.profiler`` trace on the same clock as the device's
events (``utils/profiling.py::span``).  This module reduces them, beside
the device events and the harness's ``bench.*`` spans, to the numbers per
frame that say which host work the device waits on:

- ``sync_copies``: the program's copy spans per frame (both directions);
- ``copy_wait_ms``: host ms per frame inside them, the host blocked on the
  stream;
- ``idle_preamble_ms``: device idle ms per frame (the gaps of
  ``harness.idle_gaps`` over the window) inside the union of the program's
  spans, the device waiting on the program's own host work;
- by innermost span: each span's own host ms per frame (its time less its
  children's) and the device idle ms per frame inside it.

Each is ``None`` where the trace holds no ``port.scene.*`` span (a program
without spans).  Run on the card:

    python3 -m port_bench.program_spans --workload <cell> --seed <n> --seconds <s>

sets the cell up as ``port_bench.run`` does, drives ``--seconds`` of its
traffic untraced (the frame time without a profiler), then traces
``harness.TRACE_SECONDS`` more, and prints one JSON line: both windows'
ms per frame, the numbers above, the check that every copy the device saw
is named (copy spans against ``Memcpy HtoD``/``DtoH`` device events) and
that every program span nests in a ``bench.*`` span, and the host cost of
one span while no profiler records.
"""

from __future__ import annotations

import argparse
import os
import collections
import json
import sys
import time

from . import harness

#: the prefix of the program's span names, and of its copy spans
PROGRAM = "port."
COPY = "port.copy."
#: what the device events of a copy between the host and the card hold in their names
MEMCPY = ("HtoD", "DtoH")


def merged(intervals) -> list:
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(i) for i in out]


def shared_us(pieces, gaps) -> list:
    """For each of sorted disjoint ``pieces``, the microseconds it shares
    with sorted disjoint ``gaps``."""
    out, j = [], 0
    for s, e in pieces:
        while j < len(gaps) and gaps[j][1] <= s:
            j += 1
        total, k = 0.0, j
        while k < len(gaps) and gaps[k][0] < e:
            total += max(0.0, min(e, gaps[k][1]) - max(s, gaps[k][0]))
            k += 1
        out.append(total)
    return out


def innermost(ranges) -> list:
    """The timeline of properly nested ``(name, start, end)`` ranges (one
    thread's) cut at their boundaries: ``(start, end, name)`` pieces, each
    named by the innermost range over it; time outside every range is left
    out."""
    out, stack = [], []  # stack: (end, name), innermost last
    cursor = None

    def close_until(t):
        nonlocal cursor
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > cursor:
                out.append((cursor, end, name))
            cursor = max(cursor, end)

    for name, s, e in sorted(ranges, key=lambda r: (r[1], -r[2])):
        if cursor is not None:
            close_until(s)
            if stack and s > cursor:
                out.append((cursor, s, stack[-1][1]))
        cursor = s
        stack.append((min(e, stack[-1][0]) if stack else e, name))
    if stack:
        close_until(float("inf"))
    return out


def has_program(program) -> bool:
    return any(name.startswith("port.scene.") for name, _, _ in program)


def sync_copies(program, frames: int):
    """Copy spans per frame."""
    if not has_program(program) or not frames:
        return None
    return sum(1 for name, _, _ in program if name.startswith(COPY)) / frames


def copy_wait_ms(program, frames: int):
    """Host ms per frame inside copy spans."""
    if not has_program(program) or not frames:
        return None
    copies = merged((s, e) for name, s, e in program if name.startswith(COPY))
    return sum(e - s for s, e in copies) / 1e3 / frames


def idle_preamble_ms(device, program, lo: float, hi: float, frames: int):
    """Device idle ms per frame inside the union of the program's spans."""
    if not has_program(program) or not frames:
        return None
    gaps = harness.idle_gaps([(s, e) for _, s, e in device], lo, hi)
    return sum(shared_us(merged((s, e) for _, s, e in program), gaps)) / 1e3 / frames


def by_span(device, program, lo: float, hi: float, frames: int):
    """Per innermost program span: ``{"self_ms", "idle_ms"}`` per frame,
    largest idle first."""
    if not has_program(program) or not frames:
        return None
    gaps = harness.idle_gaps([(s, e) for _, s, e in device], lo, hi)
    pieces = innermost(program)
    own, idle = collections.Counter(), collections.Counter()
    for (s, e, name), shared in zip(pieces, shared_us([(s, e) for s, e, _ in pieces], gaps)):
        own[name] += e - s
        idle[name] += shared
    rows = {n: {"self_ms": own[n] / 1e3 / frames, "idle_ms": idle[n] / 1e3 / frames}
            for n in own}
    return dict(sorted(rows.items(), key=lambda kv: -kv[1]["idle_ms"]))


def nested_in_bench(program, spans) -> bool:
    """Whether every program span lies inside one of the harness's spans."""
    bench = sorted((s, e) for _, s, e in spans)
    return all(any(bs <= s and e <= be for bs, be in bench) for _, s, e in program)


# -- on the card -------------------------------------------------------------------


def traced(torch_mod, program, traffic, clock, seconds: float, first: int) -> tuple:
    """``harness.traced``'s window, with the program's spans kept:
    ``(harness.Trace, program spans (name, start_us, end_us), device
    events named as a program span)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch_mod.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            t0 = time.perf_counter()
            units, _, _ = harness.drive(program, traffic, clock, seconds, first=first,
                                        label=record_function, whole_periods=False)
            torch_mod.cuda.synchronize()
            wall = time.perf_counter() - t0
    device, spans, ours, mirrored, window = [], [], [], 0, None
    for e in prof.events():
        r = e.time_range
        on_device = e.device_type == DeviceType.CUDA
        if e.name.startswith("bench."):
            if on_device:
                continue
            if e.name == "bench.window":
                window = (r.start, r.end)
            else:
                spans.append((e.name, r.start, r.end))
        elif e.name.startswith(PROGRAM):
            if on_device:
                mirrored += 1
            else:
                ours.append((e.name, r.start, r.end))
        elif on_device:
            device.append((e.name, r.start, r.end))
    if not device:
        raise RuntimeError("the trace holds no device event")
    lo, hi = window if window is not None else (min(s for _, s, _ in device),
                                                max(e for _, _, e in device))
    for u in units:
        u.out = None
    trace = harness.Trace(device=device, spans=spans, units=units, wall_s=wall, lo_us=lo,
                          hi_us=hi)
    return trace, ours, mirrored


def span_cost_us(calls: int = 200_000):
    """Host µs of one span while no profiler records, or ``None`` where the
    port has none."""
    try:
        from godot_atmosphere_shader_tpu_torch.utils.profiling import span
    except ImportError:
        return None
    t0 = time.perf_counter()
    for _ in range(calls):
        with span("port.scene.render"):
            pass
    return (time.perf_counter() - t0) / calls * 1e6


def measure(args) -> dict:
    import torch

    from .program import Program
    from .run import _warm, power_limit
    from .workload import Traffic

    bench = harness.load_benchmark(os.getcwd())
    cell = harness.find_cell(bench, args.workload)
    config = harness.load_config(cell["config"])
    traffic = Traffic(harness.load_traffic(cell["traffic"]), args.seed)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    program = Program(config, torch.device("cuda", 0))
    clock = harness.Clock(torch)
    _warm(program, traffic)
    torch.cuda.synchronize()
    units, start, end = harness.drive(program, traffic, clock, args.seconds)
    done = sum(u.frames for u in units if u.end is not None and u.end <= end)
    frames = sum(u.frames for u in units)
    trace, ours, mirrored = traced(torch, program, traffic, clock, harness.TRACE_SECONDS,
                                   first=units[-1].index + 1)
    t_frames = sum(u.frames for u in trace.units)
    copies = sum(1 for n, _, _ in ours if n.startswith(COPY))
    memcpy = sum(1 for n, _, _ in trace.device if any(m in n for m in MEMCPY))
    lo, hi = trace.lo_us, trace.hi_us
    return {
        "workload": args.workload, "seed": args.seed, "card": power_limit(),
        "window": {"seconds": end - start, "frames": done,
                   "ms_per_frame": (end - start) * 1e3 / done,
                   "host_ms_per_frame": sum(u.host_s for u in units) * 1e3 / frames},
        "traced": {"seconds": trace.wall_s, "frames": t_frames,
                   "ms_per_frame": trace.wall_s * 1e3 / t_frames,
                   "idle_share": 100.0 * (1.0 - harness.busy_us(
                       [(s, e) for _, s, e in trace.device]) / 1e6 / trace.wall_s)},
        "spans_per_frame": len(ours) / t_frames,
        "span_cost_us": span_cost_us(),
        "sync_copies": sync_copies(ours, t_frames),
        "copy_wait_ms": copy_wait_ms(ours, t_frames),
        "idle_preamble_ms": idle_preamble_ms(trace.device, ours, lo, hi, t_frames),
        "memcpy_events_per_frame": memcpy / t_frames,
        "copies_named": copies == memcpy if ours else None,
        "nested_in_bench": nested_in_bench(ours, trace.spans) if ours else None,
        "device_mirrors": mirrored,
        "by_span": by_span(trace.device, ours, lo, hi, t_frames),
        "idle_by_bench_span": harness.breakdown(trace)["idle_gaps"],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    print(json.dumps(measure(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
