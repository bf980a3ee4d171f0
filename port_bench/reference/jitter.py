"""Blue-noise screen-space jitter: the reference's
``texelFetch(ivec2(pixel) & 0xff)`` of a 256² blue-noise texture, and the
per-frame temporal offset of flight mode.

The asset is the package's own ``assets/blue_noise_256.npy`` (the same
bytes as the JAX package's committed asset).  A missing asset is an error:
there is no fallback noise.
"""

from __future__ import annotations

import os

import numpy as np
import torch

#: the asset is a raw input file that the program ships; the reference reads
#: its bytes from the checkout and imports nothing of the program
BLUE_NOISE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "godot_atmosphere_shader_tpu_torch", "assets", "blue_noise_256.npy")
#: golden-ratio step of the temporal jitter sequence, per second of scene time
TEMPORAL_JITTER_RATE = 38.196601125


def blue_noise_256() -> np.ndarray:
    """The committed 256×256 blue-noise asset (f32 values in [0, 1))."""
    if not os.path.exists(BLUE_NOISE_PATH):
        raise FileNotFoundError(
            f"blue-noise asset missing: {BLUE_NOISE_PATH} (it ships with the "
            "package; nothing stands in for it)")
    return np.load(BLUE_NOISE_PATH).astype(np.float32)


def blue_noise_tensor(*, device) -> torch.Tensor:
    """The asset as a contiguous ``(256, 256)`` f32 tensor on ``device``."""
    return torch.as_tensor(blue_noise_256(), device=device).contiguous()


def jitter_plane(height: int, width: int, *, device, row0: int = 0) -> torch.Tensor:
    """Jitter of ``height`` rows from frame row ``row0``: the asset tiled
    across the framebuffer (256-periodic, so a band's rows equal the full
    frame's rows there)."""
    tile = blue_noise_tensor(device=device)
    tile = torch.roll(tile, -(row0 % 256), dims=0)
    reps_y = -(-height // 256)
    reps_x = -(-width // 256)
    return tile.repeat(reps_y, reps_x)[:height, :width]


def temporal_offset(time_s) -> float:
    """``frac(time · 38.196601125)`` in float32, as the device computes it:
    frame ``t``'s jitter is ``frac(blue + offset)``, so successive frames
    of a flight get decorrelated jitter (``VariantConfig.temporal_jitter``)."""
    toff = np.float32(time_s) * np.float32(TEMPORAL_JITTER_RATE)
    return float(toff - np.floor(toff))


def apply_temporal_offset(jitter: torch.Tensor, offset: float) -> torch.Tensor:
    """``frac(jitter + offset)`` elementwise (the kernel's order)."""
    jitter = jitter + offset
    return jitter - torch.floor(jitter)
