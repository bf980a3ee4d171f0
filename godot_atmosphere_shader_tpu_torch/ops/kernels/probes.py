"""Measurement probes: the launch floor of a flight (T3) and the card's
arithmetic ceilings (T2).

* :func:`fill` is the counterpart of the TPU probe
  ``tools/profile_small.py::trivial_scan_totals`` (a do-nothing Pallas tile
  kernel under ``lax.map``): it writes one scalar to every pixel of an
  ``(h, w)`` float32 plane on the 32×128 tile grid.  CPU tensors take the
  plain version (:func:`fill_plain`, ``torch.full``); on a CUDA device it
  launches ``csrc/probes.cu``'s ``fill_kernel``.  Launched K times back to
  back it gives the least time a flight frame can cost on the card.
* :func:`peak_chains` is the counterpart of ``tools/vpu_peak.py::
  _run_chain``: independent register-resident chains per thread of one
  operation (:data:`PEAK_OPS`: ``y = fma(y, a, b)``, ``y = exp(−|y|)``,
  the raw SFU ``__expf``, or ``y = y·a + b`` on uint32), timed on the card
  for the peak rates; its plain version :func:`chains_plain` runs the same
  chains in PyTorch (a multiply then an add where the kernel fuses them).

Both count their launches in :data:`counters`.
"""

from __future__ import annotations

import ctypes

import torch

from ..noise import _MASK32, _mul32
from . import library

FILL_ARGTYPES = (ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
PEAK_ARGTYPES = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p)
#: the peak probe's chain operations, by their codes in ``peak_launch``
PEAK_OPS = {"fma": 0, "exp": 1, "fast_exp": 2, "imad": 3}
#: its shape: chains per thread, the (16, 128) plane of a and b, threads
#: per block, and each op's steps per chain and loop iteration (``PEAK_*``
#: in probes.cu)
PEAK_CHAINS, PEAK_PLANE, PEAK_THREADS = 16, 2048, 256
PEAK_INNER = {"fma": 64, "exp": 8, "fast_exp": 8, "imad": 64}


class Counters:
    """Launches of the fill kernel and of the peak probe."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.launches = 0
        self.peak_launches = 0


counters = Counters()


def fill_plain(value: float, height: int, width: int, *, device) -> torch.Tensor:
    return torch.full((height, width), float(value), dtype=torch.float32, device=device)


_LAUNCHER = None


def launch_fill(value: float, out: torch.Tensor):
    """One launch into a preallocated contiguous ``(h, w)`` float32 CUDA
    plane, on the current stream of its device (:func:`library.launch`)."""
    global _LAUNCHER
    if out.dim() != 2:
        raise ValueError(f"fill writes an (h, w) plane (got {tuple(out.shape)})")
    if _LAUNCHER is None:
        if not out.is_cuda:  # the route refuses it; no build for it either
            raise ValueError(f"fill launches on a CUDA plane (got {out.device})")
        _LAUNCHER = library.function("fill_launch", FILL_ARGTYPES)
    h, w = out.shape
    rc = library.launch(_LAUNCHER, out, (float(value), out.data_ptr(), h, w))
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


def chains_plain(a: torch.Tensor, b: torch.Tensor, op: str, iters: int) -> torch.Tensor:
    """The peak probe's chains for one thread per element of the (2048,)
    float32 planes ``a`` and ``b`` (the kernel's thread ``i`` takes element
    ``i % 2048``), ``iters · PEAK_INNER[op]`` steps each: the sum over the
    chains, as the kernel writes it (``imad``: the uint32 sum >> 8).  The
    chains are advanced together, one ``(PEAK_CHAINS, 2048)`` tensor per
    step, except the ``exp`` chains of CPU tensors: PyTorch's CPU ``exp``
    splits a tensor of more than 2048 elements across threads, and the
    first such call in a process can take one thread's share through a
    far less accurate exp (relative error ~1e-4, seen in about 1 process
    of 12 under load); each chain is advanced as its own (2048,) row there,
    which the calling thread takes whole."""
    if op not in PEAK_OPS:
        raise ValueError(f"op must be one of {sorted(PEAK_OPS)}")
    steps = iters * PEAK_INNER[op]
    k = torch.arange(PEAK_CHAINS, device=a.device)[:, None]
    if op == "imad":
        ua = (a.view(torch.int32).to(torch.int64) & _MASK32) | 1
        ub = b.view(torch.int32).to(torch.int64) & _MASK32
        ys = (_mul32(ua, k + 1) + ub) & _MASK32
        for _ in range(steps):
            ys = (_mul32(ys, ua) + ub) & _MASK32
        return ((ys.sum(0) & _MASK32) >> 8).to(torch.float32)
    coef = torch.tensor([0.4 + 0.01 * j for j in range(PEAK_CHAINS)], dtype=torch.float32,
                        device=a.device)[:, None]
    ys = a * coef + b
    if op == "fma":
        for _ in range(steps):
            ys = ys * a + b
    else:
        parts = (ys,) if ys.is_cuda else ys.unbind(0)
        for _ in range(steps):
            parts = [torch.exp(-p.abs()) for p in parts]
        ys = torch.cat([p.reshape(-1, PEAK_PLANE) for p in parts])
    acc = ys[0]
    for j in range(1, PEAK_CHAINS):
        acc = acc + ys[j]
    return acc


_PEAK = None


def peak_chains(a: torch.Tensor, b: torch.Tensor, op: str, iters: int,
                blocks: int) -> torch.Tensor:
    """``blocks · PEAK_THREADS`` threads of the peak probe's chains over the
    (2048,) float32 planes ``a`` and ``b``: ``(blocks · PEAK_THREADS,)``
    float32, thread ``i``'s chain sum.  CPU tensors take
    :func:`chains_plain` (each thread's value repeated); CUDA tensors launch
    ``peak_kernel`` on the current stream (counted in
    ``counters.peak_launches``)."""
    global _PEAK
    if op not in PEAK_OPS:
        raise ValueError(f"op must be one of {sorted(PEAK_OPS)}")
    if (a.shape != (PEAK_PLANE,) or b.shape != (PEAK_PLANE,) or a.dtype != torch.float32
            or b.dtype != torch.float32 or a.device != b.device):
        raise ValueError(f"a and b must be ({PEAK_PLANE},) float32 tensors on one device")
    if blocks < 1 or (blocks * PEAK_THREADS) % PEAK_PLANE or iters < 0:
        raise ValueError(f"blocks must be a positive multiple of {PEAK_PLANE // PEAK_THREADS}")
    n = blocks * PEAK_THREADS
    if a.device.type == "cpu":
        return chains_plain(a, b, op, iters).repeat(n // PEAK_PLANE)
    if a.device.type != "cuda":
        raise ValueError(f"the peak probe runs on CUDA devices (got {a.device})")
    if _PEAK is None:
        _PEAK = library.function("peak_launch", PEAK_ARGTYPES)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty(n, dtype=torch.float32, device=a.device)
    rc = library.launch(_PEAK, out, (PEAK_OPS[op], a.data_ptr(), b.data_ptr(), int(iters),
                                     int(blocks), out.data_ptr()))
    if rc != 0:
        raise RuntimeError(f"peak launch failed: CUDA error {rc}")
    counters.peak_launches += 1
    return out
