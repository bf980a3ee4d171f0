"""Far-mode LOD: the screen-space row band of an atmosphere shell.

Counterpart of ``godot_atmosphere_shader_tpu/render/lod.py``, host float64
numpy.  The reference's far mode swaps the fullscreen quad for a
world-space cube mesh so that only the pixels the atmosphere can touch run
the fragment shader (``planet_atmosphere.gd:261-321``).  Here a far-mode
layer launches the megakernel over the conservative row band of its
projected shell, and the rest of the frame passes through.

The vertical extremes of a perspective-projected sphere lie in the plane
``x = cx``, so the bound reduces to 2D tangents from the origin to the
circle ``(cy, cz, r)``.  Bands start on a multiple of 8 rows and are a
multiple of :data:`BAND_QUANTUM` rows high, so a band's row groups of
``cloud_lod · cloud_coverage_lod ≤ 8`` rows line up with the fullscreen
frame's: a banded procedural layer equals the fullscreen one.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np

#: band heights are multiples of this many rows
BAND_QUANTUM = 64
#: extra rows beyond the analytic bound, for f32 rounding at the silhouette
BAND_MARGIN_ROWS = 4

#: the shell is entirely behind the camera (or off the frame): the layer is
#: dropped, every ray misses it
EMPTY = "empty"


def projected_row_band(view_to_world, fov_y_rad: float, height: int,
                       center, radius: float,
                       ) -> Union[None, str, Tuple[int, int]]:
    """Conservative screen-row interval touched by a sphere.

    Returns ``None`` for the full frame (camera inside the sphere, sphere
    crossing the camera plane, or a band of most of the frame),
    :data:`EMPTY` when no row can see the sphere, or ``(row0,
    band_height)`` with ``row0 % 8 == 0`` and ``band_height %
    BAND_QUANTUM == 0``.
    """
    m = np.asarray(view_to_world, np.float64)
    r_mat = m[:3, :3]
    t = m[:3, 3]
    c_view = r_mat.T @ (np.asarray(center, np.float64) - t)
    cy, cz = float(c_view[1]), float(c_view[2])
    r = float(radius)

    if cz - r >= 0.0:
        return EMPTY  # entirely behind the camera plane
    d2 = cy * cy + cz * cz
    if d2 <= r * r or cz + r >= 0.0:
        return None  # inside the (y, z) silhouette circle or straddling z = 0

    d = math.sqrt(d2)
    theta_c = math.atan2(cy, -cz)  # angle from the forward (−z) axis
    alpha = math.asin(min(r / d, 1.0))
    tan_f = math.tan(0.5 * float(fov_y_rad))

    def ndc_of(theta):
        if theta >= 0.5 * math.pi:
            return float("inf")
        if theta <= -0.5 * math.pi:
            return float("-inf")
        return math.tan(theta) / tan_f

    # ndc_y → row: row = (1 − ndc_y) / 2 · height (the top row is +1)
    row_top = (1.0 - ndc_of(theta_c + alpha)) * 0.5 * height
    row_bot = (1.0 - ndc_of(theta_c - alpha)) * 0.5 * height
    lo = math.floor(row_top) - BAND_MARGIN_ROWS
    hi = math.ceil(row_bot) + BAND_MARGIN_ROWS
    if hi <= 0 or lo >= height:
        return EMPTY  # projects wholly above or below the frame
    lo = max(lo, 0)
    hi = min(hi, height)

    row0 = (lo // 8) * 8
    band_h = hi - row0
    band_h = ((band_h + BAND_QUANTUM - 1) // BAND_QUANTUM) * BAND_QUANTUM
    if row0 + band_h > height:
        row0 = max(0, height - band_h)
        if row0 % 8:
            row0 = (row0 // 8) * 8
        band_h = min(((height - row0 + BAND_QUANTUM - 1) // BAND_QUANTUM)
                     * BAND_QUANTUM, height)
        if row0 + band_h > height:
            return None
    if band_h >= height - BAND_QUANTUM // 2:
        return None  # nearly fullscreen: a band buys nothing
    return int(row0), int(band_h)


def layer_band(atmo_mode: int, view_to_world, fov_y_rad: float, height: int,
               center, planet_radius: float, atmosphere_height: float,
               mode_far: int = 1):
    """Band decision for one layer: near mode keeps the fullscreen pass, as
    the reference's fullscreen quad does (``planet_atmosphere.gd:261-282``)."""
    if atmo_mode != mode_far:
        return None
    return projected_row_band(view_to_world, fov_y_rad, height, center,
                              planet_radius + atmosphere_height)
