"""Blue-noise screen-space jitter: the reference's
``texelFetch(ivec2(pixel) & 0xff)`` of a 256² blue-noise texture.

The asset is the JAX package's committed ``assets/blue_noise_256.npy``,
loaded by file path (the JAX package is never imported).  A missing asset
is an error: there is no fallback noise.
"""

from __future__ import annotations

import os

import numpy as np
import torch

BLUE_NOISE_PATH = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..",
    "godot_atmosphere_shader_tpu", "assets", "blue_noise_256.npy"))


def blue_noise_256() -> np.ndarray:
    """The committed 256×256 blue-noise asset (f32 values in [0, 1))."""
    if not os.path.exists(BLUE_NOISE_PATH):
        raise FileNotFoundError(
            f"blue-noise asset missing: {BLUE_NOISE_PATH} (it ships with the "
            "repository; nothing stands in for it)")
    return np.load(BLUE_NOISE_PATH).astype(np.float32)


def blue_noise_tensor(*, device) -> torch.Tensor:
    """The asset as a contiguous ``(256, 256)`` f32 tensor on ``device``."""
    return torch.as_tensor(blue_noise_256(), device=device).contiguous()


def jitter_plane(height: int, width: int, *, device) -> torch.Tensor:
    """Full-frame jitter: the asset tiled across the framebuffer."""
    tile = blue_noise_tensor(device=device)
    reps_y = -(-height // 256)
    reps_x = -(-width // 256)
    return tile.repeat(reps_y, reps_x)[:height, :width]
