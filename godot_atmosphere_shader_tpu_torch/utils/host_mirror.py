"""Host mirrors of the small tensors the port uploads itself.

A frame's preamble reads back values that were on the host a moment
earlier: the camera's pose and lens, the packed frame state, a layer's
uniforms, the opaque scene.  A device→host copy waits for the stream to
drain, that is for every kernel queued before it, so a frame whose
preamble copies can never overlap the frame before it on the card.

:func:`upload` makes the device tensor from a host value without a
synchronising copy (from pinned memory, ``non_blocking``) and keeps the
host value it uploaded, in the tensor's dtype, as the tensor's mirror.
:func:`hosts` (and :func:`host`) returns the mirror while the tensor is the
one it mirrors and unchanged since (the same object, the same
``_version``, and the mirror itself unchanged); any other tensor is read
back with one copy, as the port always did, and that copy becomes its
mirror.  An in-place edit, an optimiser step or a new tensor
(``set_shader_parameter``) thus falls back to a copy, and no stale value
is ever served.

A mirror lives exactly as long as its tensor: a weak reference drops the
entry when the tensor goes.  :data:`counters` counts the tensors read from
their mirrors (``hits``) and the copies made for the rest (``copies``, one
per transfer, however many tensors it carries; a host tensor with no
mirror is copied on the host, with no span and no wait).
"""

from __future__ import annotations

import functools
import weakref

import torch

from .profiling import span


class Counters:
    """Reads served by a mirror and device→host copies made instead."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.hits = 0
        self.copies = 0


counters = Counters()

#: id(tensor) → (a weak reference to it, its ``_version``, its host mirror,
#: the mirror's ``_version``)
_MIRRORS = {}


def _forget(key, ref):
    entry = _MIRRORS.get(key)
    if entry is not None and entry[0] is ref:
        del _MIRRORS[key]


def _remember(t: torch.Tensor, mirror: torch.Tensor):
    key = id(t)
    _MIRRORS[key] = (weakref.ref(t, functools.partial(_forget, key)), t._version,
                     mirror, mirror._version)


def _mirror(t: torch.Tensor):
    entry = _MIRRORS.get(id(t))
    if entry is None:
        return None
    ref, version, mirror, mirror_version = entry
    if ref() is not t or t._version != version or mirror._version != mirror_version:
        return None
    return mirror


def upload(value, device, dtype=torch.float32, site: str = "port.copy.upload") -> torch.Tensor:
    """``value`` (host array, number or CPU tensor) as a new tensor of
    ``dtype`` (``None``: the value's own) on ``device``, with its mirror.
    To a card it is copied from pinned memory without waiting for the
    stream, in the span ``site``; on the CPU the tensor is a copy of its
    own beside the mirror."""
    device = torch.device(device)
    value = torch.as_tensor(value.detach() if isinstance(value, torch.Tensor) else value,
                            dtype=dtype, device="cpu")
    if device.type == "cuda":
        mirror = value.pin_memory()
        with span(site, device):
            t = mirror.to(device, non_blocking=True)
    else:
        mirror = value.clone()
        t = mirror.to(device, copy=True)
    _remember(t, mirror)
    return t


def hosts(tensors, site: str) -> list:
    """Each tensor's value on the host, in its dtype and shape: its mirror
    where it has one, else one copy of all the others together (one
    transfer, one wait for the stream), in the span ``site``, which then
    become their mirrors.  Treat what it returns as read-only."""
    out = [_mirror(t) for t in tensors]
    missing = [t for t, m in zip(tensors, out) if m is None]
    counters.hits += len(tensors) - len(missing)
    if not missing:
        return out
    flat = torch.cat([t.detach().reshape(-1) for t in missing])
    with span(site, flat.device):
        flat = flat.cpu()
    counters.copies += 1
    at, read = 0, {}
    for t in missing:
        m = flat[at:at + t.numel()].reshape(t.shape).to(t.dtype)
        at += t.numel()
        _remember(t, m)
        read[id(t)] = m
    return [read[id(t)] if m is None else m for t, m in zip(tensors, out)]


def host(t: torch.Tensor, site: str) -> torch.Tensor:
    """:func:`hosts` of one tensor."""
    return hosts((t,), site)[0]
