"""Per-frame statistics of a render: rays, worst-case samples per ray,
frame latency and Mrays/s; and the spans that name the program's host work
in a ``torch.profiler`` trace.

Counterpart of ``FrameStats``, ``samples_per_ray`` and ``FrameTimer`` of
``godot_atmosphere_shader_tpu/utils/profiling.py``.  A frame's time is its
latency: :meth:`FrameTimer.frame` synchronises the device at the end of the
frame, as the JAX timer's fetch of a pixel does.

:func:`span` marks the host preamble of ``Scene.update``, ``Scene.render``
and ``Scene.render_flight`` by function (``port.<module>.<function>``) and
every host↔device copy on those paths (``port.copy.<site>``), so a trace
says which host work the device waits on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import TYPE_CHECKING

import torch
from torch._C._profiler import _RecordFunctionFast

if TYPE_CHECKING:  # params uploads through host_mirror, which imports this module
    from ..models.params import VariantConfig

#: what :func:`span` returns while no profiler records
_OFF = contextlib.nullcontext()


@dataclasses.dataclass
class FrameStats:
    height: int
    width: int
    frame_ms: float
    mrays_per_s: float
    atmosphere_steps: int
    cloud_steps: int
    samples_per_ray: int  # worst-case density evaluations

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def samples_per_ray(config: VariantConfig) -> int:
    """Worst-case density evaluations per pixel (the reference's ≈448 for
    clouds_high_rm: 64 cloud steps × (1 + 6 sun samples) + 8 atmosphere)."""
    n = config.atmosphere_steps
    if config.clouds_enabled:
        n += config.cloud_steps * (7 if config.raymarched_lighting else 1)
    return n


class FrameTimer:
    """Times render calls, each to the end of its device work, and
    accumulates :class:`FrameStats`."""

    def __init__(self, height: int, width: int, config: VariantConfig, device="cuda"):
        self.height = height
        self.width = width
        self.config = config
        self.device = torch.device(device)
        self.frames = []

    @contextlib.contextmanager
    def frame(self):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.frames.append(time.perf_counter() - t0)

    def stats(self) -> FrameStats:
        if not self.frames:
            raise RuntimeError("no frames timed")
        dt = sum(self.frames) / len(self.frames)
        return FrameStats(
            height=self.height, width=self.width, frame_ms=dt * 1e3,
            mrays_per_s=self.height * self.width / dt / 1e6,
            atmosphere_steps=self.config.atmosphere_steps,
            cloud_steps=self.config.cloud_steps if self.config.clouds_enabled else 0,
            samples_per_ray=samples_per_ray(self.config))


def span(name: str, device=None):
    """A named range of the program's host work in a ``torch.profiler``
    trace: ``with span("port.scene.render"): ...``.

    While no profiler session records, it costs one check and opens
    nothing.  While one records, it is a CPU range on the trace's clock,
    nested under the range around it on the same thread.  The range is
    recorded at function scope, as PyTorch's operators are, so it puts no
    event on the device's timeline (``record_function`` would mirror it
    there, over the kernels launched inside it).  ``device``: the span of
    a copy between the host and ``device``, opened only where that is a
    CUDA device (a host tensor's copy to the host copies nothing)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    if device is not None and torch.device(device).type != "cuda":
        return _OFF
    return _RecordFunctionFast(name)
