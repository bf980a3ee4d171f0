"""Measurement probes: the launch floor of a flight.

Counterpart of the TPU probe ``tools/profile_small.py::trivial_scan_totals``
(a do-nothing Pallas tile kernel under ``lax.map``): :func:`fill` writes one
scalar to every pixel of an ``(h, w)`` float32 plane on the 32×128 tile
grid.  CPU tensors take the plain version (:func:`fill_plain`,
``torch.full``); on a CUDA device it launches ``csrc/probes.cu``'s
``fill_kernel`` (counted in :data:`counters`).  Launched K times back to
back it gives the least time a flight frame can cost on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import library

FILL_ARGTYPES = (ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


class Counters:
    """Launches of the fill kernel."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.launches = 0


counters = Counters()


def fill_plain(value: float, height: int, width: int, *, device) -> torch.Tensor:
    return torch.full((height, width), float(value), dtype=torch.float32, device=device)


_LAUNCHER = None


def launch_fill(value: float, out: torch.Tensor):
    """One launch into a preallocated contiguous ``(h, w)`` float32 CUDA
    plane, on the current stream of its device."""
    global _LAUNCHER
    if out.device.type != "cuda" or out.dtype != torch.float32 or out.dim() != 2 \
            or not out.is_contiguous():
        raise ValueError("fill needs a contiguous (h, w) float32 CUDA tensor")
    if _LAUNCHER is None:
        _LAUNCHER = library.function("fill_launch", FILL_ARGTYPES)
    fn = _LAUNCHER
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(float(value), out.data_ptr(), out.shape[0], out.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"fill launch failed: CUDA error {rc}")
    counters.launches += 1


def fill(value: float, height: int, width: int, *, device="cuda") -> torch.Tensor:
    """An ``(h, w)`` float32 plane of ``value`` on ``device``."""
    device = torch.device(device)
    if device.type == "cpu":
        return fill_plain(value, height, width, device=device)
    if device.type != "cuda":
        raise ValueError(f"fill runs on CUDA devices (got {device})")
    out = torch.empty((height, width), dtype=torch.float32, device=device)
    launch_fill(value, out)
    return out
