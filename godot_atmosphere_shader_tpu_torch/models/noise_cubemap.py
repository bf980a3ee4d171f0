"""``NoiseCubemap`` resource: a procedural cubemap of projected 3-D noise.

Counterpart of ``godot_atmosphere_shader_tpu/models/noise_cubemap.py``
(``noise_cubemap.gd``): the ``noise``/``resolution``/``scale`` properties
with deferred, coalesced regeneration on change, and the 3×2-atlas
importable-image export of the editor plugin (``tools/plugin.gd``).  The
six faces bake in one PyTorch pass on ``device`` (``ops/sampling.py::
bake_noise_cubemap``).  As in the reference, face data is never serialized:
the exported PNG is the persistence path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.noise import NoiseSpec
from ..ops.sampling import bake_noise_cubemap
from ..utils.image_io import cubemap_atlas, to_uint8, write_import_file, write_png


class NoiseCubemap:
    """The reference's defaults: ``FastNoiseLite.new()``, resolution 256,
    scale (100, 100, 100); faces baked on ``device`` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, noise: Optional[NoiseSpec] = None, resolution: int = 256,
                 scale: Tuple[float, float, float] = (100.0, 100.0, 100.0), *,
                 device="cuda"):
        self._noise = noise if noise is not None else NoiseSpec()
        self._resolution = resolution
        self._scale = tuple(float(s) for s in scale)
        self.device = torch.device(device)
        self._faces = None
        self._dirty = True
        self.generation_count = 0

    # -- properties with deferred regeneration (noise_cubemap.gd:9-64) -------

    @property
    def noise(self) -> NoiseSpec:
        return self._noise

    @noise.setter
    def noise(self, value: NoiseSpec):
        self._noise = value
        self._dirty = True

    @property
    def resolution(self) -> int:
        return self._resolution

    @resolution.setter
    def resolution(self, value: int):
        value = int(np.clip(value, 1, 4096))  # clampi (noise_cubemap.gd:30)
        if value != self._resolution:
            self._resolution = value
            self._dirty = True

    @property
    def scale(self) -> Tuple[float, float, float]:
        return self._scale

    @scale.setter
    def scale(self, value):
        value = tuple(float(s) for s in value)
        if value != self._scale:
            self._scale = value
            self._dirty = True

    # -- generation ------------------------------------------------------------

    def get_faces(self) -> np.ndarray:
        """``(6, res, res)`` float32 in [0, 1] on the host; regenerated
        lazily after a change (many property writes, one bake:
        ``noise_cubemap.gd:61-64``)."""
        if self._dirty or self._faces is None:
            faces = bake_noise_cubemap(self._noise, self._scale, self._resolution,
                                       device=self.device)
            self._faces = faces.cpu().numpy()
            self._dirty = False
            self.generation_count += 1
        return self._faces

    def generate_importable_image(self) -> np.ndarray:
        """6 faces → 3×2 atlas (``noise_cubemap.gd:93-97,143-155``)."""
        return cubemap_atlas(self.get_faces())

    def save_as_image(self, png_path: str) -> str:
        """The editor plugin's "Bake as importable image" flow
        (``tools/plugin.gd:54-88``): atlas PNG and ``.import`` sidecar;
        returns the sidecar's path."""
        write_png(png_path, to_uint8(self.generate_importable_image()))
        return write_import_file(png_path)
