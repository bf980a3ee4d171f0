"""HDR glow (bloom), the demo environment's output stage.

Counterpart of ``godot_atmosphere_shader_tpu/render/glow.py``, in plain
PyTorch as the JAX package leaves it to XLA (outside any kernel): a
luminance soft-threshold bright pass, a 2× mip chain with a separable
3-tap blur per level, the weighted sum of the levels upsampled to the
frame, composited additively with ``glow_intensity``.  Same formulas and
operation order as the JAX stage; it runs on the frame's device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class GlowSettings:
    """Environment glow parameters.  ``levels``: weights of blur mips 1..7
    (Godot's ``glow_levels/1..7``; index 0 is the half-resolution mip)."""

    enabled: bool = True
    levels: Tuple[float, ...] = (0.0, 0.0, 0.0, 1.0, 0.0, 1.0, 0.0)
    intensity: float = 0.8
    strength: float = 1.04
    hdr_threshold: float = 1.0
    hdr_scale: float = 2.0
    bloom: float = 0.0

    @staticmethod
    def demo() -> "GlowSettings":
        """The demo scene's Environment block (``planet_atmosphere_test.tscn:26-35``)."""
        return GlowSettings(levels=(0.0, 0.0, 0.0, 1.0, 0.0, 1.0, 0.0),
                            intensity=4.0, strength=0.8, hdr_scale=1.0)


def _blur3(x: torch.Tensor) -> torch.Tensor:
    """Separable 3-tap [1, 2, 1]/4 blur of an (H, W, C) image, edges clamped."""
    def axis_blur(a, ax):
        n = a.shape[ax]
        p = torch.cat([a.narrow(ax, 0, 1), a, a.narrow(ax, n - 1, 1)], dim=ax)
        return 0.25 * p.narrow(ax, 0, n) + 0.5 * a + 0.25 * p.narrow(ax, 2, n)

    return axis_blur(axis_blur(x, 0), 1)


def _down2(x: torch.Tensor) -> torch.Tensor:
    """2× box downsample; an odd row or column at the end is dropped."""
    h, w, c = x.shape
    return x[: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2, c).mean(dim=(1, 3))


def _up2(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize to exactly (h, w), half-pixel centres, edges clamped
    (``jax.image.resize(..., "bilinear")`` when upsampling)."""
    up = F.interpolate(x.permute(2, 0, 1)[None], size=(h, w), mode="bilinear",
                       align_corners=False, antialias=False)
    return up[0].permute(1, 2, 0)


def apply_glow(img: torch.Tensor, settings: GlowSettings) -> torch.Tensor:
    """The glow chain composited over a linear HDR frame (H, W, 3); the
    result stays linear."""
    if not settings.enabled:
        return img
    img = img.to(torch.float32)
    h, w, _ = img.shape
    total_w = sum(settings.levels)
    if total_w <= 0.0:
        return img

    # bright pass: luminance soft threshold (bloom lifts the floor)
    lum = img.amax(dim=-1, keepdim=True)
    over = torch.clamp(lum - settings.hdr_threshold, min=0.0) * settings.hdr_scale
    wgt = over / torch.clamp(lum, min=1e-4)
    wgt = wgt + settings.bloom * (1.0 - wgt)
    bright = img * wgt

    # mip chain: downsample and blur per level, then the weighted sum of the
    # levels upsampled to the frame
    reps = max(1, int(round(2.0 * settings.strength)))
    cur = _blur3(bright)
    glow = None
    for wl in settings.levels:
        if min(cur.shape[0], cur.shape[1]) < 2:
            break
        cur = _down2(cur)
        for _ in range(reps):
            cur = _blur3(cur)
        if wl:
            u = wl * _up2(cur, h, w)
            glow = u if glow is None else glow + u
    if glow is None:
        return img
    # additive blend; 0.25 calibrates the demo settings to a halo of a few
    # sun-disc radii at 1080p (the JAX stage's documented approximation)
    return img + (0.25 * settings.intensity / total_w) * glow
