"""Color management: Godot converts ``source_color`` uniforms from sRGB to
linear before they reach the shader; the scene API does the same at the
boundary, and everything inside the renderer is linear."""

from __future__ import annotations

import torch


def srgb_to_linear(c, *, device) -> torch.Tensor:
    c = torch.as_tensor(c, dtype=torch.float32, device=device)
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c.to(torch.float32), 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)
