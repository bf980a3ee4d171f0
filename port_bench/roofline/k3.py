"""K3's least time per resolve: it depends on the pixel count alone.  Per
pixel (``counts.OPS_TAA_PIXEL``, ``counts.BYTES_TAA_PIXEL``): the ray and
reprojection, the history window and the bilinear reads of four planes, the
3×3 clamp of three channels and the blend, ~300 fp32 operations; the
current color and depth and the history color and depth read once, the
resolved color and depth written once, 48 bytes."""

from . import counts
from .peaks import bound_ms


def resolve_bound_ms(height: int, width: int) -> float:
    pixels = height * width
    return bound_ms(pixels * counts.OPS_TAA_PIXEL, 0, pixels * counts.BYTES_TAA_PIXEL)
