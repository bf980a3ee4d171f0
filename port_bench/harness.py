"""The harness: finds a cell's configuration, traffic mix and metrics by
name, drives the window, and reduces spans, events and traces to the
numbers the metric readers take.

Everything of one configuration, mix or metric lives in a file of its own,
found by the name that ``BENCHMARK.json`` gives: ``configs/<name>.json``,
``traffic/<name>.json`` (or another of :data:`TRAFFIC_SUFFIXES`, which the
one generator, :mod:`port_bench.workload`, would have to read) and
``metrics/<name>.py``.  An unknown name is refused.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib.util
import json
import os
import time
from typing import Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TRAFFIC_SUFFIXES = (".json",)
#: seconds of the traced sub-window of a ``--trace 1`` run
TRACE_SECONDS = 2.0


class Refused(ValueError):
    """A name the benchmark does not know, or a file it cannot use."""


# -- finding things by name -----------------------------------------------------------


def load_benchmark(root: str) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise Refused(f"no BENCHMARK.json in {root}")
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise Refused(f"unknown workload {name!r}")


def _named_file(folder: str, name: str, suffixes, base: str = HERE) -> str:
    if not name or "/" in name or name.startswith("."):
        raise Refused(f"bad name {name!r}")
    for suffix in suffixes:
        path = os.path.join(base, folder, name + suffix)
        if os.path.exists(path):
            return path
    raise Refused(f"no {folder}/{name} with a suffix of {suffixes}")


def load_config(name: str, base: str = HERE) -> dict:
    with open(_named_file("configs", name, (".json",), base)) as f:
        return json.load(f)


def load_traffic(name: str, base: str = HERE) -> dict:
    with open(_named_file("traffic", name, TRAFFIC_SUFFIXES, base)) as f:
        return json.load(f)


def load_metric(name: str, base: str = HERE):
    """The reader module of a metric: ``metrics/<name>.py`` with ``read(run)``."""
    path = _named_file("metrics", name, (".py",), base)
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not callable(getattr(module, "read", None)):
        raise Refused(f"metrics/{name}.py has no read(run)")
    return module


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a cell reports: end-to-end without a trace,
    per-layer with one; an entry with ``workloads`` only in those cells."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


# -- statistics ----------------------------------------------------------------------


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all values, linear between order
    statistics (numpy's default)."""
    if len(values) == 0:
        raise ValueError("a percentile of no values")
    return float(np.percentile(np.asarray(values, np.float64), q))


def busy_us(intervals) -> float:
    """Microseconds covered by the union of ``(start, end)`` intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The gaps in ``[lo, hi]`` that no interval covers: ``(start, end)``."""
    gaps, cursor = [], lo
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    return [g for g in gaps if g[1] > g[0]]


# -- the window ---------------------------------------------------------------------


@dataclasses.dataclass
class Unit:
    """One frame (``frames`` mix) or one flight call: its index, the host
    clock at the start of its host work, the host time spent in the
    program's calls, and the end of its device work on the host clock."""

    index: int
    frames: int
    start: float
    host_s: float
    end: Optional[float] = None
    out: Optional[dict] = None


@dataclasses.dataclass
class Trace:
    """A reduced ``torch.profiler`` trace: device events ``(name, start_us,
    end_us)``, the harness's host spans ``(name, start_us, end_us)`` on the
    same clock, the units whose work ran inside it and its wall seconds."""

    device: list
    spans: list
    units: list
    wall_s: float
    lo_us: float
    hi_us: float


@dataclasses.dataclass
class Run:
    """What a run hands the metric readers."""

    cell: dict
    config: dict
    traffic: object  # workload.Traffic
    setup_s: float
    units: list  # the window's units, retired
    window_start: float
    window_end: float
    trace: Optional[Trace] = None
    ref_scene: object = None  # reference.scene.RefScene, built once the window has closed

    @property
    def window_ms(self) -> float:
        return (self.window_end - self.window_start) * 1e3

    def done(self) -> list:
        """Units whose device work finished inside the window."""
        return [u for u in self.units if u.end is not None and u.end <= self.window_end]


class Clock:
    """The host clock, and the device's end of a unit placed on it through
    one anchor event recorded on an idle device."""

    def __init__(self, torch_mod):
        self.torch = torch_mod
        torch_mod.cuda.synchronize()
        self.anchor = torch_mod.cuda.Event(enable_timing=True)
        self.t0 = time.perf_counter()
        self.anchor.record()
        torch_mod.cuda.synchronize()

    def event(self):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def end_of(self, ev) -> float:
        ev.synchronize()
        return self.t0 + self.anchor.elapsed_time(ev) / 1e3


class CpuClock:
    """The CPU's stand-in for :class:`Clock` (the CPU dry run): a unit
    ends when its call returns."""

    def event(self):
        return time.perf_counter()

    def end_of(self, ev) -> float:
        return ev


def drive(program, traffic, clock, seconds: float, first: int = 0, keep=(), label=None,
          whole_periods: bool = True):
    """Run the mix from unit ``first`` for ``seconds``, and on to the end of
    the mix's period (``traffic.period`` units, one loop of the path) in
    which they end, so that every run covers the same frames whatever the
    seed: each unit starts once unit ``i - in_flight`` has retired.
    ``whole_periods=False``: stop at ``seconds``.  ``keep``: unit indices
    whose outputs are kept (and the last unit's always are).  ``label``: a
    context manager factory ``label(name)`` around each call (the traced
    run's host spans).  Returns ``(units, window_start, window_end)``: the
    window ends with the last unit's device work."""
    taa = traffic.mix.get("taa")
    flight = traffic.mix["mode"] == "flight"
    inflight = collections.deque()
    units = []
    null = contextlib.nullcontext if label is None else label

    def retire():
        unit, ev = inflight.popleft()
        unit.end = clock.end_of(ev)
        if unit.index not in keep and unit is not units[-1]:
            unit.out = None

    t_start = time.perf_counter()
    t_end = t_start + seconds
    period = traffic.period if whole_periods else 1
    i = first
    while True:
        if len(inflight) >= traffic.in_flight:
            retire()
        now = time.perf_counter()
        if now >= t_end and (i - first) % period == 0:
            break
        if flight:
            poses, times = traffic.unit(i)
            with null("bench.render_flight"):
                cam = program.camera(poses[0])
                out = program.render_flight(cam, times, poses, traffic.height, traffic.width, taa)
        else:
            pose, t = traffic.frame(i)
            with null("bench.update"):
                cam = program.camera(pose)
                program.update(cam, t)
            with null("bench.render"):
                out = program.render(cam, traffic.height, traffic.width)
        host = time.perf_counter() - now
        unit = Unit(index=i, frames=traffic.frames_per_unit, start=now, host_s=host, out=out)
        units.append(unit)
        inflight.append((unit, clock.event()))
        i += 1
    while inflight:
        retire()
    return units, t_start, max((u.end for u in units), default=t_end)


def traced(torch_mod, program, traffic, clock, seconds: float, first: int):
    """One ``torch.profiler`` trace of ``seconds`` of the mix from unit
    ``first``; fails where it holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch_mod.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            t0 = time.perf_counter()
            units, _, _ = drive(program, traffic, clock, seconds, first=first,
                                label=record_function, whole_periods=False)
            torch_mod.cuda.synchronize()
            wall = time.perf_counter() - t0
    device, spans, window = [], [], None
    for e in prof.events():
        r = e.time_range
        if e.name.startswith("bench."):  # the harness's spans, also mirrored on the device
            if e.device_type == DeviceType.CUDA:
                continue
            if e.name == "bench.window":
                window = (r.start, r.end)
            else:
                spans.append((e.name, r.start, r.end))
        elif e.device_type == DeviceType.CUDA:
            device.append((e.name, r.start, r.end))
    if not device:
        raise RuntimeError("the trace holds no device event")
    lo, hi = window if window is not None else (min(s for _, s, _ in device),
                                                max(e for _, _, e in device))
    for u in units:
        u.out = None
    return Trace(device=device, spans=spans, units=units, wall_s=wall, lo_us=lo, hi_us=hi)


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took most time, and the idle time
    of the device by what the host was doing (the harness's span around
    it, else ``host.other``), in seconds."""
    by_op = collections.Counter()
    for name, s, e in trace.device:
        by_op[name[:120]] += (e - s) / 1e6
    gaps = idle_gaps([(s, e) for _, s, e in trace.device], trace.lo_us, trace.hi_us)
    spans = sorted((s, e, n) for n, s, e in trace.spans)
    by_host = collections.Counter()
    for gs, ge in gaps:
        label = "host.other"
        for s, e, n in spans:
            if s <= gs < e:
                label = n
            if s > gs:
                break
        by_host[label] += (ge - gs) / 1e6
    return {"device_ops": [[n, v] for n, v in by_op.most_common(10)],
            "idle_gaps": [[n, v] for n, v in by_host.most_common(10)]}


def kernels(trace: Trace, names) -> list:
    """Device events whose name holds any of ``names``, in start order."""
    return sorted((e for e in trace.device if any(n in e[0] for n in names)),
                  key=lambda e: e[1])
