"""The fused frame megakernel: wrapper, plain version and build.

Counterpart of ``godot_atmosphere_shader_tpu/ops/pallas/megakernel.py``
(the Pallas kernel ``_make_kernel``) with the texture samplers of
``ops/pallas/texsample.py`` inside it.  One launch of the CUDA kernel
(``csrc/megakernel.cu``) renders one atmosphere layer over the whole frame,
a far-mode row band or a row shard: ray generation, the opaque pass (or, for a
chained layer, the layers below read back from the frame), the v1 or v2
atmosphere (analytic sun optical depth), the cloud march with cheap or
sun-marched light, and the composite; or the opaque pass alone.  The
launch that runs the opaque pass draws the panorama sky (three channel
pyramids sampled by K2's lat-long device functions, one level and mode per
32×128 tile of rays; the procedural and cloud-free instances read them
from a per-tile pre-pass, :func:`sky_choices`) where a scene has one.  It
has three instances: the procedural instance for every procedural config
the JAX megakernel renders (every basis and fractal, fields per step or
from knots in shared memory, the detail field, LOD groups up to 32 rows),
the cloud-free instance (layers without clouds, the opaque-only pass) and
texture mode (baked fields sampled through mip pyramids by the K2 device
functions, each batch's level and mode from a 32×128 tile): the fixed
instance for the demo's profile, one thread block per tile, and the
general one for every other texture config the JAX megakernel renders (a
baked field beside a procedural one, full quality, any knot count, knot
group and LOD group), a tile pass that shades the rows and makes the
tiles' choices (:func:`launch` returns them), then the frame.

* :func:`render_scene_megakernel` renders a frame of any number of layers
  (the counterpart of ``render_scene_pallas``): CPU tensors take the plain
  chain, CUDA tensors launch the kernel once per layer (plus the
  opaque-only pass when layer 0 is banded) into preallocated outputs, or
  raise.  Nothing falls back.  :func:`render_frame_megakernel` is the same
  for one fullscreen layer.  :func:`launch` is one launch on a prepared
  launch struct.
* :func:`render_scene_band_megakernel` and :func:`render_band_megakernel`
  render one row shard of a frame (the counterparts of
  ``render_scene_band_pallas`` and ``render_band_pallas``): layer 0 fuses
  the opaque pass and the sky over the shard's rows, the later layers
  composite over them (:func:`band_launches`); ``parallel/sharding.py``
  puts the shards together.
* :func:`render_frame_plain`, :func:`render_scene_plain` and
  :func:`render_scene_band_plain` are the plain PyTorch versions
  (``render/renderer.py``), the reference the kernel is held against.
* :func:`render_flight_megakernel` and :func:`render_flight_taa` render
  K frames of a flight (counterparts of ``render_flight_pallas`` and
  ``render_flight_taa``): every frame's launch structs are computed on the
  host first, then the launches (one per layer, and, with TAA, the resolve
  K3 of ``taa.py`` after each frame) go back to back on one stream, with
  no device→host copy between the first launch and the last.
* :func:`sample_batches` runs K2 alone on caller-given batches (the
  counterpart of the TPU test harness around the samplers): the plain
  samplers on the CPU, the kernel's device functions on a card.
* :data:`counters` counts kernel launches and plain calls, so a run can
  show which path it took.

The kernel builds at first use with the port's other kernels
(``library.py``: ``nvcc`` for ``sm_90a``, plain C interface, bound with
``ctypes``) into ``build/`` at the root of the checkout; every launcher goes
through ``library.launch``.

The per-frame scalar preamble (ray scale, planet center, sun direction,
radii, model-space camera, march clamp, noise amplitudes) is computed once
on the host by :func:`frame_constants`, with the same PyTorch functions the
plain path uses.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ...models.params import AtmosphereParams, VariantConfig
from ...render.jitter import blue_noise_tensor, temporal_offset
from ...render.opaque import OpaqueScene
from ...render.renderer import (TILE_COLS, TILE_ROWS, opaque_only_config, planet_center,
                                render_flight_plain, render_frame, render_scene,
                                render_scene_band, shared_reverse_z)
from ...utils import host_mirror
from ...utils.camera import Camera, ray_scale, transform_dir, transform_point, world_ray_dirs
from ...utils.profiling import span
from ...utils.vecmath import Vec3, normalize
from ..atmosphere_v2 import scattering_coefficients
from ..clouds import SUN_REACH, SUN_STEPS, cloud_settings, march_distance_limit
from ..noise import NoiseSpec, fractal_bounding
from ..optical_depth import gauss_legendre_01
from . import library, taa, texsample

SOURCE = os.path.join(library.CSRC, "megakernel.cu")

# the launch structs' inline entries (the #defines of csrc/megakernel.cu):
# a scene's first INLINE_SPHERES spheres, INLINE_BOXES boxes and each noise
# spec's first INLINE_OCTAVES octaves sit in the struct, the rest in the
# scene's float buffer on the device (:func:`scene_buffer`; a launch that
# reads it takes each kernel's EXT instance, ``megakernel_gen<C, true>``,
# the others the struct's code alone): GEOM_SPHERE
# floats per sphere (center, radius², albedo, unshaded), GEOM_BOX per box
# (world_to_box row-major, half size, albedo), EXT_OCTAVE per octave (amp,
# warp_amp, warp_freq)
INLINE_SPHERES = 8
INLINE_BOXES = 4
INLINE_OCTAVES = 8
GEOM_SPHERE = 8
GEOM_BOX = 22
EXT_OCTAVE = 3
#: the fixed texture instance's rows per thread
MAX_GROUP = 8
QUAD_POINTS = 8
#: the fixed texture instance's coverage knot count (template parameter K)
KNOTS = 8
#: the procedural instance's coarse pixels per thread, C = cloud_coverage_lod
#: (a group of cloud_lod·C rows divides the 32-row tile)
GEN_COARSE = (1, 2, 4, 8, 16, 32)
#: the procedural instance's dynamic shared memory, in rows of one float per
#: thread of its 128-thread block (512 B; ``MK_*`` of ``csrc/megakernel.cu``):
#: at most SMEM_ROWS (the 227 KB a block may use), of which the knots take
#: one row each, a coarse pixel of the group GEN_MARCH_ROWS (its march
#: inputs) and, where they fit, a row of the group GEN_CACHE_ROWS (the row
#: cache: one opaque pass per pixel)
SMEM_ROWS = 454
GEN_MARCH_ROWS = 6
GEN_CACHE_ROWS = 4
#: texture mode: the fixed instance's shape knot count, the pyramid levels
#: the launch struct holds and the batch modes (as ``texsample.py`` numbers
#: them); its tile is the plain renderer's ``TILE_ROWS × TILE_COLS``
SHAPE_KNOTS = 16
MAX_LEVELS = 16
WINDOWED, BANDED, FLOOR = texsample.WINDOWED, texsample.BANDED, texsample.FLOOR
#: where a texture-mode field comes from (``TexParams.shape_source``,
#: ``cov_source``; ``MK_SRC_*``): knots sampled from its pyramid, knots
#: evaluated from its procedural spec, its procedural spec per step
SOURCE_PYRAMID, SOURCE_KNOTS, SOURCE_STEP = 0, 1, 2
#: the fixed texture instance's rows per thread, cloud_lod·cloud_coverage_lod:
#: one instance each (``megakernel_tex<K, KS, G>``) for the demo's profile
#: (both fields baked, K = KNOTS, KS = SHAPE_KNOTS, low quality), a block of
#: 128 × 32 / G threads per 32×128 tile, registers sized for TEX_SM_THREADS
#: resident threads per SM (one tile at G = 4, two at G = 8); every other
#: texture config takes the general instance ``megakernel_tex_general``
#: (:func:`tex_general_layout`); the launcher picks (``tex_instance`` in the
#: source, :func:`fixed_texture_instance` its mirror) and reports its pick
TEXTURE_GROUPS = (4, 8)
TEX_SM_THREADS = 1024
#: its shared memory: the 9 coverage and 17 shape knots in rows of one float
#: per thread, then TEX_RED_SLOTS floats per warp (the block reduction's
#: min and max of up to 3 axes)
TEX_KNOT_ROWS = 26
TEX_RED_SLOTS = 6
#: the general texture instance's tile pass (``tex_choice_kernel``, the
#: first of its two launches: each row's shading and the tile's choices):
#: at most TEXG_CHOICE_ROWS thread rows of 128 per tile, TEXG_GROUP_FLOATS
#: floats per coverage group of the tile (its knot inputs: mean model-space
#: ray, mean span) in shared memory, the warps' partials of TEXG_CHUNK
#: choice slots per barrier; a slot without a choice (the sky's, where the
#: launch draws none) holds NO_CHOICE twice.  Its scratch for the frame
#: (:func:`tex_scratch_floats`): each row's atmosphere rgba, and
#: TEXG_IN_PLANES floats per coarse pixel (its GEN_MARCH_ROWS march inputs
#: and its visibility).
TEXG_CHOICE_ROWS = 4
TEXG_GROUP_FLOATS = 5
TEXG_CHUNK = 32
TEXG_IN_PLANES = 7
NO_CHOICE = -1
#: work counter slots, in the kernel's order (``MK_WORK_*``); the procedural
#: instance also counts its procedural field evaluations: coverage per step
#: and per sun sample, shape and detail per step and per sun sample, and the
#: shape and detail knots; and its march's warp-steps issued and lane-steps
#: run (lane utilisation = lane-steps / (32 × warp-steps); no bound reads
#: them).  Every instance counts the quadrature segments of the v2 sun
#: optical depth it evaluated (``od_segments``: the kernel skips an empty
#: one, so these inputs need fewer than two per step).
WORK_SLOTS = ("pixels", "atmosphere", "knot_groups", "march", "tex3d",
              "tex3d_floor", "latlong", "latlong_floor", "sun_samples",
              "v1_atmosphere", "opaque_pixels", "sky", "sky_floor",
              "coverage_evals", "shape_evals", "detail_evals", "shape_knots",
              "detail_knots", "march_warp_steps", "march_lane_steps", "od_segments")
#: the measurement build's (``MEASURE_DEFINES``) per-stage cycles of the
#: procedural and texture instances, summed over warps, after the work
#: slots (``MK_STAGE_*``): the coarse pass, the knots, the march, the
#: shading and blend; and the general texture instance's tile pass: the
#: rows' shading with every coverage group's coarse inputs, the knot
#: batches' choices
STAGE_SLOTS = ("coarse", "knots", "march", "blend", "choice_coarse", "choice")
MEASURE_DEFINES = ("MK_STAGE_CLOCKS",)
#: what :func:`gen_info` reports of the procedural instance
GEN_INFO = ("coarse", "registers", "stack_bytes", "blocks_per_sm", "smem_bytes", "row_cache")
#: what :func:`tex_info` reports of the texture instance (``general``:
#: TEX_GENERAL for ``megakernel_tex_general``, 0 for the fixed instance, as
#: the launcher also reports the instance it launched; ``MK_TEX_*``); the
#: general instance's tile pass's block (zeros for the fixed instance)
TEX_INFO = ("group", "registers", "stack_bytes", "blocks_per_sm", "smem_bytes", "threads",
            "general", "choice_threads", "choice_smem_bytes", "choice_registers",
            "choice_blocks_per_sm")
TEX_GENERAL = 1
#: what :func:`clear_info` reports of the cloud-free instance
CLEAR_INFO = ("registers", "stack_bytes", "blocks_per_sm", "threads", "blocks")
#: atmosphere models, by their integer codes
MODELS = {"v2": 0, "v1": 1}
#: noise bases, fractals and cellular returns, by their integer codes
NOISE_TYPES = {"value": 0, "simplex_smooth": 1, "perlin": 2, "simplex": 3, "cellular": 4,
               "cellular_fast": 5}
FRACTAL_TYPES = {"none": 0, "fbm": 1, "ridged": 2, "ping_pong": 3}
CELLULAR_RETURNS = {"distance": 0, "distance2": 1, "cell_value": 2}


class Counters:
    """Plain integer counters: frame-kernel launches (every instance, every
    layer and the opaque-only pass; ``general_launches`` counts the
    procedural instance ``megakernel_gen`` alone, ``texture_launches`` the texture instance,
    ``clear_launches`` the cloud-free instance ``megakernel_clear``,
    ``texture_general_launches`` the general texture instance
    ``megakernel_tex_general`` alone,
    ``sky_launches`` the launches that draw the panorama sky), launches of
    the sky's per-tile choice pre-pass, of the general texture instance's
    tile pass (``tex_choice_kernel``, launched before each of its frames),
    of the K2-alone entry, and plain-path
    frames (one per frame, whatever its layers)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.megakernel_launches = 0
        self.general_launches = 0
        self.texture_launches = 0
        self.texture_general_launches = 0
        self.clear_launches = 0
        self.sky_launches = 0
        self.sky_choice_launches = 0
        self.tex_choice_launches = 0
        self.texsample_launches = 0
        self.plain_calls = 0


counters = Counters()


def _floats(n):
    return ctypes.c_float * n


class NoiseParams(ctypes.Structure):
    """Mirror of ``struct NoiseParams`` in ``csrc/megakernel.cu``."""

    _fields_ = [
        ("noise_type", ctypes.c_int),
        ("fractal_type", ctypes.c_int),
        ("octaves", ctypes.c_int),
        ("seed", ctypes.c_int),
        ("frequency", ctypes.c_float),
        ("lacunarity", ctypes.c_float),
        ("gain", ctypes.c_float),
        ("ping_pong_strength", ctypes.c_float),
        ("weighted_strength", ctypes.c_float),
        ("cellular_jitter", ctypes.c_float),
        ("cellular_return", ctypes.c_int),
        ("amp", _floats(INLINE_OCTAVES)),
        ("warp_enabled", ctypes.c_int),
        ("warp_octaves", ctypes.c_int),
        ("warp_amp", _floats(INLINE_OCTAVES)),
        ("warp_freq", _floats(INLINE_OCTAVES)),
        ("scale", _floats(3)),
        ("ext_octaves", ctypes.c_int),
        ("ext_warp_octaves", ctypes.c_int),
        ("ext", ctypes.c_void_p),
    ]


class MegakernelParams(ctypes.Structure):
    """Mirror of ``struct MegakernelParams`` in ``csrc/megakernel.cu``."""

    _fields_ = [
        ("height", ctypes.c_int),
        ("width", ctypes.c_int),
        ("row0", ctypes.c_int),
        ("rows", ctypes.c_int),
        ("cam_pos", _floats(3)),
        ("cam_rot", _floats(9)),
        ("ray_sx", ctypes.c_float),
        ("ray_sy", ctypes.c_float),
        ("jitter_offset", ctypes.c_float),
        ("with_atmosphere", ctypes.c_int),
        ("with_background", ctypes.c_int),
        ("with_opaque", ctypes.c_int),
        ("n_spheres", ctypes.c_int),
        ("n_boxes", ctypes.c_int),
        ("sphere_center", _floats(INLINE_SPHERES * 3)),
        ("sphere_radius2", _floats(INLINE_SPHERES)),
        ("sphere_albedo", _floats(INLINE_SPHERES * 3)),
        ("sphere_unshaded", _floats(INLINE_SPHERES)),
        ("box_w2b", _floats(INLINE_BOXES * 16)),
        ("box_origin", _floats(INLINE_BOXES * 3)),
        ("box_half", _floats(INLINE_BOXES * 3)),
        ("box_albedo", _floats(INLINE_BOXES * 3)),
        ("light_dir", _floats(3)),
        ("ambient", ctypes.c_float),
        ("sky_color", _floats(3)),
        ("star_intensity", ctypes.c_float),
        ("with_sky", ctypes.c_int),
        ("model", ctypes.c_int),
        ("atmosphere_steps", ctypes.c_int),
        ("planet_center", _floats(3)),
        ("planet_radius", ctypes.c_float),
        ("atmosphere_height", ctypes.c_float),
        ("atmosphere_radius", ctypes.c_float),
        ("atmosphere_radius2", ctypes.c_float),
        ("planet_radius2", ctypes.c_float),
        ("inv_height", ctypes.c_float),
        ("density", ctypes.c_float),
        ("density2", ctypes.c_float),
        ("sphere_depth_factor", ctypes.c_float),
        ("scatter", _floats(3)),
        ("ambient_color", _floats(3)),
        ("modulate", _floats(3)),
        ("sun_dir", _floats(3)),
        ("quad_x", _floats(QUAD_POINTS)),
        ("quad_w", _floats(QUAD_POINTS)),
        ("day_color0", _floats(3)),
        ("day_color1", _floats(3)),
        ("night_color0", _floats(3)),
        ("night_color1", _floats(3)),
        ("day_night_transition_scale", ctypes.c_float),
        ("clouds_enabled", ctypes.c_int),
        ("cloud_steps", ctypes.c_int),
        ("raymarched_lighting", ctypes.c_int),
        ("cloud_lod", ctypes.c_int),
        ("coverage_lod", ctypes.c_int),
        ("coverage_knots", ctypes.c_int),
        ("coverage_interp", ctypes.c_int),
        ("shape_interp", ctypes.c_int),
        ("shape_knots", ctypes.c_int),
        ("always_low", ctypes.c_int),
        ("time", ctypes.c_float),
        ("cloud_bottom_radius", ctypes.c_float),
        ("cloud_top_radius", ctypes.c_float),
        ("cloud_bottom_radius2", ctypes.c_float),
        ("cloud_top_radius2", ctypes.c_float),
        ("cloud_layer", ctypes.c_float),
        ("cloud_density_scale", ctypes.c_float),
        ("cloud_blend", ctypes.c_float),
        ("cloud_shape_invert", ctypes.c_float),
        ("cloud_coverage_bias", ctypes.c_float),
        ("cloud_shape_factor", ctypes.c_float),
        ("cloud_shape_scale", ctypes.c_float),
        ("cloud_shape_bound", ctypes.c_float),
        ("cloud_detail_term", ctypes.c_float),
        ("march_max_distance", ctypes.c_float),
        ("sun_step0", ctypes.c_float),
        ("coverage_rot", _floats(4)),
        ("world_to_model", _floats(16)),
        ("ro_model", _floats(3)),
        ("sd_model", _floats(3)),
        ("shape", NoiseParams),
        ("coverage", NoiseParams),
        ("ext_spheres", ctypes.c_int),
        ("ext_boxes", ctypes.c_int),
        ("geom", ctypes.c_void_p),
    ]


def _ints(n):
    return ctypes.c_int * n


class TexParams(ctypes.Structure):
    """Mirror of ``struct TexParams`` in ``csrc/megakernel.cu``."""

    _fields_ = [
        ("shape_levels", ctypes.c_int),
        ("shape_size", _ints(MAX_LEVELS)),
        ("shape_base", _ints(MAX_LEVELS)),
        ("shape_floor", ctypes.c_int),
        ("cov_levels", ctypes.c_int),
        ("cov_height", _ints(MAX_LEVELS)),
        ("cov_width", _ints(MAX_LEVELS)),
        ("cov_base", _ints(MAX_LEVELS)),
        ("cov_floor", ctypes.c_int),
        ("window_rows", ctypes.c_int),
        ("band_rows", ctypes.c_int),
        ("band_max_slices", ctypes.c_int),
        ("knot_group", ctypes.c_int),
        ("shape_knots", ctypes.c_int),
        ("shape_source", ctypes.c_int),
        ("cov_source", ctypes.c_int),
    ]


#: The launchers' C signatures, as the ctypes binding declares them (the
#: second TexParams is the sky's, NULL without a sky).
LAUNCHER_ARGTYPES = (ctypes.POINTER(MegakernelParams), ctypes.POINTER(TexParams),
                     *(ctypes.c_void_p,) * 10)
SKY_CHOICE_ARGTYPES = (ctypes.POINTER(MegakernelParams), ctypes.POINTER(TexParams),
                       ctypes.c_void_p, ctypes.c_void_p)
TEX_LAUNCHER_ARGTYPES = (ctypes.POINTER(MegakernelParams), ctypes.POINTER(TexParams),
                         ctypes.POINTER(TexParams), *(ctypes.c_void_p,) * 11, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_int)
TEXSAMPLE_ARGTYPES = (ctypes.POINTER(TexParams), ctypes.c_int, *(ctypes.c_void_p,) * 4,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, *(ctypes.c_void_p,) * 3)
GEN_INFO_ARGTYPES = (ctypes.POINTER(MegakernelParams), ctypes.c_void_p)
TEX_INFO_ARGTYPES = (ctypes.POINTER(MegakernelParams), ctypes.POINTER(TexParams), ctypes.c_void_p,
                     ctypes.c_int)
CLEAR_INFO_ARGTYPES = GEN_INFO_ARGTYPES


# -- binding --------------------------------------------------------------------


_LIBRARY = None


def bind(lib):
    """Bind the megakernel's launchers on a loaded kernel library and check
    the launch structs' mirrors against it; returns ``lib``."""
    for name, argtypes in (("megakernel_launch", LAUNCHER_ARGTYPES),
                           ("sky_choice_launch", SKY_CHOICE_ARGTYPES),
                           ("megakernel_tex_launch", TEX_LAUNCHER_ARGTYPES),
                           ("texsample_launch", TEXSAMPLE_ARGTYPES),
                           ("megakernel_gen_info", GEN_INFO_ARGTYPES),
                           ("megakernel_tex_info", TEX_INFO_ARGTYPES),
                           ("megakernel_clear_info", CLEAR_INFO_ARGTYPES),
                           ("megakernel_work_slots", ()),
                           ("megakernel_params_size", ()),
                           ("megakernel_noise_params_size", ()),
                           ("megakernel_tex_params_size", ())):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, struct in (("megakernel_params_size", MegakernelParams),
                         ("megakernel_noise_params_size", NoiseParams),
                         ("megakernel_tex_params_size", TexParams)):
        size = getattr(lib, name)()
        if size != ctypes.sizeof(struct):
            raise RuntimeError(f"{struct.__name__} mirror is {ctypes.sizeof(struct)}"
                               f" bytes, the kernel's struct {size}")
    if lib.megakernel_work_slots() != len(WORK_SLOTS):
        raise RuntimeError(f"the kernel writes {lib.megakernel_work_slots()} work slots, "
                           f"WORK_SLOTS names {len(WORK_SLOTS)}")
    return lib


def load_library():
    """Build (if needed) and load the kernel library, bind the megakernel's
    launchers and check the launch structs' mirrors; cached per process."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = bind(library.load_library())
    return _LIBRARY


@contextlib.contextmanager
def use_library(path: str):
    """Inside the block, every megakernel launch goes through the kernel
    library at ``path``: another build of ``csrc/megakernel.cu`` with the
    same launchers (the measurement build, :data:`MEASURE_DEFINES`, or
    another commit's source, for a comparison on one card)."""
    global _LIBRARY
    saved = load_library()
    _LIBRARY = bind(ctypes.CDLL(path))
    try:
        yield _LIBRARY
    finally:
        _LIBRARY = saved


def gen_info(struct: MegakernelParams) -> dict:
    """What the procedural instance that would launch ``struct`` uses on
    this card (:data:`GEN_INFO`): registers, local memory (stack), resident
    blocks per SM, dynamic shared memory, and whether its rows take one
    opaque pass (the row cache)."""
    out = (ctypes.c_int * len(GEN_INFO))()
    rc = load_library().megakernel_gen_info(ctypes.byref(struct), out)
    if rc != 0:
        raise RuntimeError(f"megakernel_gen_info failed: CUDA error {rc}")
    return dict(zip(GEN_INFO, out))


def tex_info(struct: MegakernelParams, tparams: TexParams, general: bool = False) -> dict:
    """What the texture instance that would launch ``struct`` with the
    pyramid struct ``tparams`` uses on this card (:data:`TEX_INFO`): its
    rows per coverage group G, registers, local memory (stack), resident
    CTAs per SM, dynamic shared memory, threads per CTA and which instance
    it is (the fixed one or the general one, as the launcher picks; the
    general one where ``general``, as :func:`launch` takes it): the fixed
    instance's one CTA per tile, the general instance's frame and, as
    ``choice_*``, its tile pass."""
    out = (ctypes.c_int * len(TEX_INFO))()
    rc = load_library().megakernel_tex_info(ctypes.byref(struct), ctypes.byref(tparams), out,
                                            int(general))
    if rc != 0:
        raise RuntimeError(f"megakernel_tex_info failed: CUDA error {rc}")
    return dict(zip(TEX_INFO, out))


def clear_info(struct: MegakernelParams) -> dict:
    """What the cloud-free instance uses on this card (:data:`CLEAR_INFO`):
    registers, local memory (stack), resident blocks per SM, threads per
    block, and the blocks it launches for ``struct``."""
    out = (ctypes.c_int * len(CLEAR_INFO))()
    rc = load_library().megakernel_clear_info(ctypes.byref(struct), out)
    if rc != 0:
        raise RuntimeError(f"megakernel_clear_info failed: CUDA error {rc}")
    return dict(zip(CLEAR_INFO, out))


# -- what the kernel takes ----------------------------------------------------


def texture_mode(config: VariantConfig) -> bool:
    """Whether the config asks for the texture instance (a pyramid meta)."""
    return config.clouds_enabled and (config.cloud_shape_tex_meta is not None
                                      or config.cloud_coverage_tex_meta is not None)


def check_config(config: VariantConfig):
    """Raise ``ValueError`` for any config outside what the kernel renders:
    v1 or v2 with analytic optical depth; clouds whose LOD group of
    cloud_lod·cloud_coverage_lod rows divides the 32-row tile, with every
    basis, fractal, octave count and knot setting the JAX megakernel
    renders (coverage and shape per step or from any number of knots, the
    detail field; the knots within a block's shared memory); in texture
    mode, each baked field
    from its pyramid beside a procedural one, as the JAX kernel's
    ``_check_config`` takes them (:func:`_texture_problems`)."""
    bad = []
    if config.model not in MODELS:
        bad.append(f"model={config.model!r} (v1 or v2)")
    if config.od_mode != "analytic":
        bad.append(f"od_mode={config.od_mode!r} (analytic only)")
    if config.clouds_enabled:
        if texture_mode(config):
            bad.extend(_texture_problems(config))
        elif config.cloud_shape_noise is None or config.cloud_coverage_noise is None:
            bad.append("baked cloud textures without pyramid metas (Scene.render "
                       "builds them)")
        else:
            bad.extend(_procedural_problems(config))
        for name in ("cloud_shape_noise", "cloud_coverage_noise"):
            field = getattr(config, name)
            if field is not None:
                bad.extend(f"{name}: {why}" for why in _noise_problems(field.noise))
    if bad:
        raise ValueError("megakernel does not render: " + "; ".join(bad))


def _group_problems(config: VariantConfig):
    group = config.cloud_lod * config.cloud_coverage_lod
    if config.cloud_lod < 1 or config.cloud_coverage_lod < 1 or TILE_ROWS % group:
        yield (f"cloud_lod·cloud_coverage_lod = {group} (it must divide the "
               f"{TILE_ROWS}-row tile)")


def _procedural_problems(config: VariantConfig):
    bad = list(_group_problems(config))
    yield from bad
    if not bad and gen_smem(config)[0] is None:
        rows = knot_rows(config) + GEN_MARCH_ROWS * config.cloud_coverage_lod
        yield (f"{knot_rows(config)} knot rows (coverage, shape and detail knots + 1 each) and "
               f"{rows - knot_rows(config)} rows of march state: {rows} rows of shared memory, "
               f"a block holds {SMEM_ROWS} ({SMEM_ROWS * TILE_COLS * 4} B)")


def gen_smem(config: VariantConfig) -> tuple:
    """The procedural instance's dynamic shared memory for ``config``, as
    its launcher lays it out: ``(bytes, row cache?)``.  The knot rows
    (:func:`knot_rows`) and GEN_MARCH_ROWS per coarse pixel of the group
    must fit SMEM_ROWS, else ``(None, False)`` (the kernel refuses the
    config); the row cache's GEN_CACHE_ROWS per row of the group join them
    where they still fit, else the group's rows take two opaque passes."""
    group = config.cloud_lod * config.cloud_coverage_lod
    rows = knot_rows(config) + GEN_MARCH_ROWS * config.cloud_coverage_lod
    if rows > SMEM_ROWS:
        return None, False
    cache = rows + GEN_CACHE_ROWS * group <= SMEM_ROWS
    return (rows + (GEN_CACHE_ROWS * group if cache else 0)) * TILE_COLS * 4, cache


def tex_threads(group: int) -> int:
    """The fixed texture instance's threads per block (one 32×128 tile) at
    G rows per thread."""
    return TILE_COLS * (TILE_ROWS // group)


def tex_smem(group: int) -> int:
    """The fixed texture instance's dynamic shared memory per block at G
    rows per thread, as its launcher sizes it (``tex_smem`` in the source),
    in bytes."""
    threads = tex_threads(group)
    return (TEX_KNOT_ROWS * threads + threads // 32 * TEX_RED_SLOTS) * 4


def knot_rows(config: VariantConfig) -> int:
    """The procedural instance's knot rows: coverage, shape and detail knots
    (each ``max(K, 1) + 1``) where interpolated."""
    cov = max(config.cloud_coverage_knots, 1) + 1 if config.cloud_coverage_interp else 0
    shape = max(config.cloud_shape_knots, 1) + 1 if config.cloud_shape_interp else 0
    return cov + shape * (1 if config.clouds_always_low_quality else 2)


def fixed_texture_instance(struct: MegakernelParams, tparams: TexParams) -> bool:
    """Whether the launcher picks the fixed texture instance
    ``megakernel_tex<K, KS, G>`` for a launch's structs (the mirror of
    ``tex_instance`` in the source, held to the launcher's report by the
    card tests): the demo's profile, both fields baked, KNOTS coverage and
    SHAPE_KNOTS shape knots, low quality, G in TEXTURE_GROUPS; the general
    instance renders every other texture config."""
    return (tparams.shape_source == SOURCE_PYRAMID and tparams.cov_source == SOURCE_PYRAMID
            and struct.coverage_knots == KNOTS and tparams.shape_knots == SHAPE_KNOTS
            and bool(struct.always_low)
            and struct.cloud_lod * struct.coverage_lod in TEXTURE_GROUPS)


def _source(meta, interp: bool) -> int:
    return SOURCE_PYRAMID if meta is not None else SOURCE_KNOTS if interp else SOURCE_STEP


def tex_general_layout(config: VariantConfig) -> Optional[dict]:
    """The general texture instance's two launches for ``config``, as its
    launcher lays them out (``texg_layout`` in the source), or ``None``
    where its frame's block does not fit.  The frame: one block of
    ``threads`` = 128 per 128 columns and coverage group row, with the knot
    rows and GEN_MARCH_ROWS per coarse pixel in shared memory, at most
    SMEM_ROWS (``smem_bytes``).  The tile pass: one block of
    ``choice_threads`` = 128 × min(TEXG_CHOICE_ROWS, the tile's rows of
    coverage groups) per tile, with TEXG_GROUP_FLOATS per coverage group of
    the tile and 6 floats per warp and choice slot of one chunk of at most
    TEXG_CHUNK slots (``choice_smem_bytes``); ``slots``: the sky's and one
    per knot batch of a baked field."""
    group = config.cloud_lod * config.cloud_coverage_lod
    if (config.cloud_lod < 1 or config.cloud_coverage_lod < 1 or TILE_ROWS % group
            or config.texture_knot_group < 1):
        return None
    k, ks = max(config.cloud_coverage_knots, 1), max(config.cloud_shape_knots, 1)
    low = config.clouds_always_low_quality
    cov = _source(config.cloud_coverage_tex_meta, config.cloud_coverage_interp)
    shape = _source(config.cloud_shape_tex_meta, config.cloud_shape_interp)
    knots = ((k + 1 if cov != SOURCE_STEP else 0)
             + ((ks + 1) * (1 if low else 2) if shape != SOURCE_STEP else 0))
    kg = config.texture_knot_group
    batches = ((k + kg) // kg if cov == SOURCE_PYRAMID else 0) + (
        (ks + kg) // kg * (1 if low else 2) if shape == SOURCE_PYRAMID else 0)
    rows = knots + GEN_MARCH_ROWS * config.cloud_coverage_lod
    if rows > SMEM_ROWS:
        return None
    group_rows = TILE_ROWS // group
    choice_rows = min(TEXG_CHOICE_ROWS, group_rows)
    warps = choice_rows * TILE_COLS // 32
    return {"threads": TILE_COLS, "smem_bytes": rows * TILE_COLS * 4, "slots": 1 + batches,
            "choice_threads": TILE_COLS * choice_rows,
            "choice_smem_bytes": (TEXG_GROUP_FLOATS * group_rows * TILE_COLS
                                  + min(1 + batches, TEXG_CHUNK) * warps * 6) * 4}


def _texture_problems(config: VariantConfig):
    """What the texture instances refuse: what the JAX kernel's
    ``_check_config`` refuses (a baked field without its knot flag, the
    band-row rules), a LOD group that does not divide the tile, and this
    port's stated limits: a meta of the wrong kind or of more than
    MAX_LEVELS levels (the launch struct's level arrays), and knots that
    leave no block of the general instance room in shared memory."""
    for name, kind in (("shape", "tex3d"), ("coverage", "latlong")):
        meta = getattr(config, f"cloud_{name}_tex_meta")
        if meta is None:
            if getattr(config, f"cloud_{name}_noise") is None:
                yield f"a baked {name} field without its pyramid meta"
            continue
        if not (isinstance(meta, texsample.TexMeta) and meta.kind == kind):
            yield f"cloud_{name}_tex_meta is not a {kind} TexMeta"
        elif len(meta.levels) > MAX_LEVELS:
            yield f"more than {MAX_LEVELS} {name} pyramid levels (the launch struct's arrays)"
        if not getattr(config, f"cloud_{name}_interp"):
            yield f"a baked {name} field needs cloud_{name}_interp (it is sampled at knots)"
    bad = list(_group_problems(config))
    yield from bad
    if config.texture_knot_group < 1:
        yield f"texture_knot_group={config.texture_knot_group} (at least 1)"
    if config.texture_window_rows < 1:
        yield f"texture_window_rows={config.texture_window_rows}"
    if config.texture_band_rows and (config.texture_band_rows % 8
                                     or config.texture_band_rows < 0):
        yield (f"texture_band_rows={config.texture_band_rows} (0, or a positive multiple "
               f"of 8)")
    if config.texture_band_rows and config.texture_band_max_slices < 1:
        yield "texture_band_max_slices < 1 with banding on"
    if not bad and config.texture_knot_group >= 1 and tex_general_layout(config) is None:
        rows = knot_rows(config) + GEN_MARCH_ROWS * config.cloud_coverage_lod
        yield (f"{knot_rows(config)} knot rows (coverage, shape and detail knots + 1 each) and "
               f"{rows - knot_rows(config)} rows of march state: {rows} rows of shared memory, "
               f"a block of the general texture instance holds {SMEM_ROWS} "
               f"({SMEM_ROWS * TILE_COLS * 4} B; tex_general_layout)")


def _noise_problems(spec: NoiseSpec):
    if spec.noise_type not in NOISE_TYPES:
        yield f"noise_type={spec.noise_type!r}"
    if spec.fractal_type not in FRACTAL_TYPES:
        yield f"fractal_type={spec.fractal_type!r}"
    if spec.cellular_return not in CELLULAR_RETURNS or (
            spec.noise_type == "cellular_fast" and spec.cellular_return != "distance"):
        yield f"cellular_return={spec.cellular_return!r} for {spec.noise_type}"


def _noise_params(spec: NoiseSpec, scale) -> tuple:
    """Static noise spec → ``(launch struct, its buffer floats)``: the
    amplitude and frequency chains in host doubles, as the plain path's
    Python loop computes them; the first INLINE_OCTAVES octaves and warp
    octaves in the struct (``octaves``, ``warp_octaves``), the rest
    (``ext_octaves``, ``ext_warp_octaves``; EXT_OCTAVE floats each) for the
    scene buffer."""
    out = NoiseParams()
    out.noise_type = NOISE_TYPES[spec.noise_type]
    out.fractal_type = FRACTAL_TYPES[spec.fractal_type]
    out.seed = spec.seed
    out.frequency = spec.frequency
    out.lacunarity = spec.lacunarity
    out.gain = spec.gain
    out.ping_pong_strength = spec.ping_pong_strength
    out.weighted_strength = spec.weighted_strength
    out.cellular_jitter = spec.cellular_jitter
    out.cellular_return = CELLULAR_RETURNS.get(spec.cellular_return, 0)
    out.warp_enabled = int(spec.warp_enabled)
    warp_octaves = spec.warp_octaves if spec.warp_enabled else 0
    # the struct counts its own octaves, the buffer the rest
    out.octaves = min(spec.octaves, INLINE_OCTAVES)
    out.warp_octaves = min(warp_octaves, INLINE_OCTAVES)
    out.ext_octaves = max(spec.octaves - INLINE_OCTAVES, 0)
    out.ext_warp_octaves = max(warp_octaves - INLINE_OCTAVES, 0)
    ext = np.zeros((max(out.ext_octaves, out.ext_warp_octaves), EXT_OCTAVE), np.float32)
    amp = fractal_bounding(spec)
    for o in range(spec.octaves):
        if o < INLINE_OCTAVES:
            out.amp[o] = amp
        else:
            ext[o - INLINE_OCTAVES, 0] = amp
        amp *= spec.gain
    wa, wf = spec.warp_amplitude, spec.warp_frequency
    for o in range(warp_octaves):
        if o < INLINE_OCTAVES:
            out.warp_amp[o], out.warp_freq[o] = wa, wf
        else:
            ext[o - INLINE_OCTAVES, 1:] = wa, wf
        wa *= spec.warp_gain
        wf *= spec.warp_lacunarity
    out.scale[:] = [float(s) for s in scale]
    return out, ext.reshape(-1)


#: the scene buffers on the devices, newest last: key → (the objects the
#: key's ids name, the pinned host copy, the device tensor)
_SCENE_BUFFERS = collections.OrderedDict()
_SCENE_BUFFER_ENTRIES = 16


def scene_buffer(opaque, parts, device) -> Optional[torch.Tensor]:
    """The scene's float buffer on ``device`` that a launch struct points
    to (``MegakernelParams.geom``, ``NoiseParams.ext``): ``parts`` are the
    host float arrays laid end to end (the spheres and boxes beyond the
    struct's, then each noise spec's octaves beyond it), ``None`` where all
    are empty.  Built on the host, uploaded from pinned memory without a
    synchronising copy, and cached per ``OpaqueScene`` object (a rebased
    scene is its own object, one per origin) and contents."""
    flat = np.concatenate([np.asarray(p, np.float32).reshape(-1) for p in parts])
    if not flat.size:
        return None
    device = torch.device(device)
    key = (id(opaque), str(device), flat.tobytes())
    hit = _SCENE_BUFFERS.get(key)
    if hit is not None and hit[0] is opaque:
        _SCENE_BUFFERS.move_to_end(key)
        return hit[2]
    host = torch.from_numpy(flat)
    if device.type == "cuda":
        host = host.pin_memory()
    with span("port.copy.scene_buffer", device):
        _SCENE_BUFFERS[key] = (opaque, host, host.to(device, non_blocking=True))
    while len(_SCENE_BUFFERS) > _SCENE_BUFFER_ENTRIES:
        _SCENE_BUFFERS.popitem(last=False)
    return _SCENE_BUFFERS[key][2]


def scene_layout(struct: MegakernelParams) -> dict:
    """Where each part of a struct's scene buffer starts, in floats, and
    its length: ``{"spheres", "boxes", "shape", "coverage": (offset,
    count)}`` (the spheres and boxes beyond the struct's inline ones, each
    noise spec's octaves beyond them; ``shape`` and ``coverage`` empty
    where the struct has no such field)."""
    out, at = {}, 0
    for name, n in (("spheres", GEOM_SPHERE * struct.ext_spheres),
                    ("boxes", GEOM_BOX * struct.ext_boxes)):
        out[name], at = (at, n), at + n
    for name in ("shape", "coverage"):
        spec = getattr(struct, name)
        n = EXT_OCTAVE * max(spec.ext_octaves, spec.ext_warp_octaves)
        out[name], at = (at, n), at + n
    return out


def _to_cpu(obj, names, site: str):
    """The named tensor fields of a dataclass on the CPU, as float32: their
    host mirrors, and one transfer of the rest (one device sync instead of
    one per field), in the span ``site`` where they are on a card
    (``host_mirror.hosts``)."""
    host = host_mirror.hosts([getattr(obj, n) for n in names], site)
    return dataclasses.replace(obj, **{n: t.to(torch.float32) for n, t in zip(names, host)})


def _set(arr, values):
    for i, v in enumerate(values):
        arr[i] = float(v)


def _floats_of(v) -> list:
    if isinstance(v, Vec3):
        return [float(c) for c in v]
    return [float(c) for c in torch.as_tensor(v).reshape(-1)]


_PARAM_FIELDS = ("planet_radius", "atmosphere_height", "sun_position",
                 "density", "sphere_depth_factor", "scattering_strength",
                 "scattering_wavelengths", "atmosphere_modulate",
                 "atmosphere_ambient_color", "cloud_density_scale",
                 "cloud_bottom", "cloud_top", "cloud_blend",
                 "cloud_shape_invert", "cloud_coverage_bias",
                 "cloud_shape_factor", "cloud_shape_scale",
                 "cloud_coverage_rotation", "world_to_model", "time",
                 "day_color0", "day_color1", "night_color0", "night_color1",
                 "day_night_transition_scale")
_OPAQUE_FIELDS = tuple(f.name for f in dataclasses.fields(OpaqueScene)
                       if f.name != "panorama")
_CAMERA_FIELDS = ("view_to_world", "fov_y_rad", "near", "far")


def frame_constants(params: AtmosphereParams, config: VariantConfig,
                    camera: Camera, opaque: Optional[OpaqueScene],
                    height: int, width: int, *, owner=None, device=None) -> MegakernelParams:
    """The kernel's launch struct: the frame's scalar preamble, computed on
    the host with the plain path's own functions, pointing at the scene's
    buffer (:func:`scene_buffer`) where the scene has more spheres, boxes
    or octaves than the struct holds: on ``device`` (default: the
    camera's), cached for ``owner`` (default: ``opaque``; a caller that
    hands over host copies names the scene they came from)."""
    with span("port.megakernel.frame_constants"):
        # the frame state resolved on the host, from its host copy
        fields = _PARAM_FIELDS + (() if params.frame_state is None else ("frame_state",))
        p = _to_cpu(params, fields, "port.copy.params").resolve_frame_state()
        cam = _to_cpu(camera, _CAMERA_FIELDS, "port.copy.camera")
        o = None if opaque is None else _to_cpu(opaque, _OPAQUE_FIELDS, "port.copy.opaque")
        s = MegakernelParams()
        s.height, s.width = height, width
        s.row0, s.rows = 0, height
        s.with_atmosphere = 1
        s.ray_sx, s.ray_sy = ray_scale(cam, height, width)

        parts = []
        if o is not None:
            ns, nb = o.sphere_centers.shape[0], o.box_world_to_box.shape[0]
            # the struct's spheres and boxes, and how many more the buffer holds
            s.with_opaque = 1
            s.n_spheres, s.n_boxes = min(ns, INLINE_SPHERES), min(nb, INLINE_BOXES)
            s.ext_spheres, s.ext_boxes = ns - s.n_spheres, nb - s.n_boxes
            spheres = torch.cat([o.sphere_centers.reshape(ns, 3),
                                 (o.sphere_radii * o.sphere_radii).reshape(ns, 1),
                                 o.sphere_albedos.reshape(ns, 3),
                                 o.sphere_unshaded.reshape(ns, 1)], dim=1).numpy()
            boxes = torch.cat([o.box_world_to_box.reshape(nb, 16), o.box_half_sizes.reshape(nb, 3),
                               o.box_albedos.reshape(nb, 3)], dim=1).numpy()
            ni, nj = min(ns, INLINE_SPHERES), min(nb, INLINE_BOXES)
            _set(s.sphere_center, spheres[:ni, 0:3].reshape(-1).tolist())
            _set(s.sphere_radius2, spheres[:ni, 3].tolist())
            _set(s.sphere_albedo, spheres[:ni, 4:7].reshape(-1).tolist())
            _set(s.sphere_unshaded, spheres[:ni, 7].tolist())
            _set(s.box_w2b, boxes[:nj, 0:16].reshape(-1).tolist())
            _set(s.box_half, boxes[:nj, 16:19].reshape(-1).tolist())
            _set(s.box_albedo, boxes[:nj, 19:22].reshape(-1).tolist())
            parts += [spheres[ni:], boxes[nj:]]
            _set(s.light_dir, o.light_dir.tolist())
            s.ambient = float(o.ambient)
            _set(s.sky_color, o.sky_color.tolist())
            s.star_intensity = float(o.star_intensity)

        ra = p.planet_radius + p.atmosphere_height
        s.model = MODELS[config.model]
        s.atmosphere_steps = config.atmosphere_steps
        s.planet_radius = float(p.planet_radius)
        s.atmosphere_height = float(p.atmosphere_height)
        s.atmosphere_radius = float(ra)
        s.atmosphere_radius2 = float(ra * ra)
        s.planet_radius2 = float(p.planet_radius * p.planet_radius)
        s.inv_height = float(1.0 / p.atmosphere_height)
        s.density = float(p.density)
        s.density2 = float(p.density * p.density)
        s.sphere_depth_factor = float(p.sphere_depth_factor)
        _set(s.scatter, [float(c) for c in scattering_coefficients(p)])
        _set(s.ambient_color, p.atmosphere_ambient_color.tolist())
        _set(s.modulate, p.atmosphere_modulate.tolist())
        nodes, weights = gauss_legendre_01(QUAD_POINTS)
        _set(s.quad_x, nodes)
        _set(s.quad_w, weights)
        for name in ("day_color0", "day_color1", "night_color0", "night_color1"):
            _set(getattr(s, name), getattr(p, name).tolist())
        s.day_night_transition_scale = float(p.day_night_transition_scale)

        if config.clouds_enabled:
            st = cloud_settings(p)
            s.clouds_enabled = 1
            s.cloud_steps = config.cloud_steps
            s.raymarched_lighting = int(config.raymarched_lighting)
            s.cloud_lod = config.cloud_lod
            s.coverage_lod = config.cloud_coverage_lod
            s.coverage_knots = max(config.cloud_coverage_knots, 1)
            s.coverage_interp = int(config.cloud_coverage_interp)
            s.shape_interp = int(config.cloud_shape_interp)
            s.shape_knots = max(config.cloud_shape_knots, 1)
            s.always_low = int(config.clouds_always_low_quality)
            s.cloud_bottom_radius = float(st.bottom_height)
            s.cloud_top_radius = float(st.top_height)
            s.cloud_bottom_radius2 = float(st.bottom_height * st.bottom_height)
            s.cloud_top_radius2 = float(st.top_height * st.top_height)
            s.cloud_layer = float(st.top_height - st.bottom_height)
            s.cloud_density_scale = float(p.cloud_density_scale)
            s.cloud_blend = float(p.cloud_blend)
            s.cloud_shape_invert = float(p.cloud_shape_invert)
            s.cloud_coverage_bias = float(p.cloud_coverage_bias)
            s.cloud_shape_factor = float(p.cloud_shape_factor)
            s.cloud_shape_scale = float(p.cloud_shape_scale)
            s.cloud_shape_bound = float(0.5 + 0.575 * p.cloud_shape_factor.abs())
            # the cull bound's detail term: 0.2 · 0.5 at low quality, 0 at full
            s.cloud_detail_term = 0.1 if config.clouds_always_low_quality else 0.0
            # the sun march's first step, (0.15 · layer) / 6 in f32 as
            # clouds.py::get_light_raymarched computes it
            layer = st.top_height - st.bottom_height
            s.sun_step0 = float((layer * SUN_REACH) / float(SUN_STEPS))
            # procedural fields (texture mode samples its pyramids instead)
            exts = {}
            for name, field in (("shape", config.cloud_shape_noise),
                                ("coverage", config.cloud_coverage_noise)):
                if field is not None:
                    spec, exts[name] = _noise_params(field.noise, field.scale)
                    setattr(s, name, spec)
            parts += [exts.get("shape", ()), exts.get("coverage", ())]
        buf = (scene_buffer(opaque if owner is None else owner, parts,
                            camera.view_to_world.device if device is None else device)
               if parts else None)
        if buf is not None:
            base = buf.data_ptr()
            lay = scene_layout(s)
            s.geom = base if lay["spheres"][1] + lay["boxes"][1] else None
            for name in ("shape", "coverage"):
                at, n = lay[name]
                getattr(s, name).ext = base + 4 * at if n else None
        _frame_fields(s, p, config, cam, o)
        return s


def _frame_fields(s: MegakernelParams, p: AtmosphereParams, config: VariantConfig,
                  cam: Camera, o: Optional[OpaqueScene]):
    """Set the struct's per-frame fields in place, from host (CPU) params
    with their frame state resolved and a host camera: everything that
    depends on the camera's transform, the sun, the world→model transform,
    the coverage rotation or the time.  A flight patches these alone."""
    ro = cam.position
    _set(s.cam_pos, _floats_of(ro))
    _set(s.cam_rot, cam.view_to_world[:3, :3].reshape(-1).tolist())
    if o is not None:
        # the inline boxes' camera positions in box space; the kernel
        # computes the buffer's boxes' the same way (xform_point_rn)
        for i in range(s.n_boxes):
            for k, v in enumerate(_floats_of(transform_point(o.box_world_to_box[i], ro))):
                s.box_origin[3 * i + k] = v
    pc = planet_center(p)
    sp = p.sun_position
    sun_dir = normalize(Vec3(sp[0], sp[1], sp[2]) - pc)
    _set(s.planet_center, _floats_of(pc))
    _set(s.sun_dir, _floats_of(sun_dir))
    s.jitter_offset = temporal_offset(float(p.time)) if config.temporal_jitter else 0.0
    s.time = float(p.time)
    if config.clouds_enabled:
        ro_model = transform_point(p.world_to_model, ro)
        s.march_max_distance = float(march_distance_limit(ro_model, cloud_settings(p)))
        _set(s.coverage_rot, p.cloud_coverage_rotation.reshape(-1).tolist())
        _set(s.world_to_model, p.world_to_model.reshape(-1).tolist())
        _set(s.ro_model, _floats_of(ro_model))
        _set(s.sd_model, _floats_of(transform_dir(p.world_to_model, sun_dir)))


def flight_constants(params: AtmosphereParams, config: VariantConfig, camera: Camera,
                     opaque: Optional[OpaqueScene], height: int, width: int,
                     frame_states: np.ndarray, cam_stack: np.ndarray) -> list:
    """Every frame's launch struct of a flight, on the host: frame 0's
    whole, then per frame a copy with its per-frame fields patched from the
    host rows ``frame_states`` (K, 24) and transforms ``cam_stack``
    (K, 4, 4).  ``params``' own frame state is ignored."""
    with span("port.megakernel.flight_constants"):
        p = _to_cpu(dataclasses.replace(params, frame_state=None), _PARAM_FIELDS,
                    "port.copy.params")
        cam = _to_cpu(camera, _CAMERA_FIELDS, "port.copy.camera")
        o = None if opaque is None else _to_cpu(opaque, _OPAQUE_FIELDS, "port.copy.opaque")
        structs = []
        for fs, vtw in zip(frame_states, cam_stack):
            p_i = dataclasses.replace(p, frame_state=torch.from_numpy(fs)).resolve_frame_state()
            cam_i = dataclasses.replace(cam, view_to_world=torch.from_numpy(vtw))
            if not structs:
                structs.append(frame_constants(p_i, config, cam_i, o, height, width, owner=opaque,
                                               device=camera.view_to_world.device))
                continue
            s = MegakernelParams.from_buffer_copy(structs[0])
            _frame_fields(s, p_i, config, cam_i, o)
            structs.append(s)
        return structs


def tex_constants(config: VariantConfig, shape: Optional[texsample.TexMeta] = None,
                  coverage: Optional[texsample.TexMeta] = None) -> TexParams:
    """Texture mode's launch struct: the pyramids' levels, the sampler
    settings and where each field comes from (metas default to the
    config's; a field without one comes from its procedural spec, at knots
    or per step as its knot flag says)."""
    shape = shape or config.cloud_shape_tex_meta
    coverage = coverage or config.cloud_coverage_tex_meta
    t = TexParams()
    w_rows = config.texture_window_rows
    if shape is not None:
        t.shape_levels = len(shape.levels)
        for i, (size, base) in enumerate(shape.levels):
            t.shape_size[i], t.shape_base[i] = size, base
        t.shape_floor = shape.floor_level(w_rows)
    if coverage is not None:
        t.cov_levels = len(coverage.levels)
        for i, (h, w, base) in enumerate(coverage.levels):
            t.cov_height[i], t.cov_width[i], t.cov_base[i] = h, w, base
        t.cov_floor = coverage.floor_level(w_rows)
    t.window_rows = w_rows
    t.band_rows = config.texture_band_rows
    t.band_max_slices = config.texture_band_max_slices
    t.knot_group = config.texture_knot_group
    t.shape_knots = config.cloud_shape_knots
    t.shape_source = _source(shape, config.cloud_shape_interp)
    t.cov_source = _source(coverage, config.cloud_coverage_interp)
    return t


def sky_constants(meta: texsample.TexMeta) -> TexParams:
    """The panorama sky's pyramid struct: its levels in the lat-long fields
    and the sky's fixed 32-row window."""
    cfg = VariantConfig(texture_window_rows=texsample.SKY_WINDOW_ROWS)
    return tex_constants(cfg, coverage=meta)


def _sky_launch(pano_data, pano_meta):
    return None if pano_data is None else (sky_constants(pano_meta), *pano_data)


# -- entry points ---------------------------------------------------------------


def render_frame_plain(params: AtmosphereParams, config: VariantConfig,
                       camera: Camera, opaque: Optional[OpaqueScene],
                       height: int, width: int, tex_data=None, pano_data=None,
                       pano_meta=None) -> dict:
    """One fullscreen layer over the opaque pass, the kernel's plain
    PyTorch version (counted in ``counters.plain_calls``); runs on any
    device.  ``tex_data``: the ``(shape, coverage)`` pyramid tables of
    texture mode; ``pano_data``/``pano_meta``: the panorama sky's."""
    counters.plain_calls += 1
    return render_frame(params, config, camera, opaque, height, width, tex_data=tex_data,
                        pano_data=pano_data, pano_meta=pano_meta)


def render_scene_plain(params_seq, configs, camera: Camera, opaque: Optional[OpaqueScene],
                       height: int, width: int, tex_data=None, bands=None,
                       band_rows=None, pano_data=None, pano_meta=None) -> dict:
    """The layer chain's plain PyTorch version (``renderer.py::
    render_scene``, counted once in ``counters.plain_calls``); runs on any
    device."""
    counters.plain_calls += 1
    return render_scene(params_seq, configs, camera, opaque, height, width, tex_data=tex_data,
                        bands=bands, band_rows=band_rows, pano_data=pano_data,
                        pano_meta=pano_meta)


_BLUE_NOISE = {}


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _plane_ptr(t: Optional[torch.Tensor], struct: MegakernelParams):
    """A frame plane's address as the kernel indexes it, by global row: a
    plane of the whole frame as it is, a plane of the launch's rows alone
    shifted back by ``row0`` rows (the kernel touches only rows ``[row0,
    row0 + rows)``, so every address it forms lies inside the plane)."""
    if t is None:
        return _ptr(None)
    if t.shape[0] == struct.height:
        return _ptr(t)
    if t.shape[0] != struct.rows or not t.is_contiguous():
        raise ValueError(f"a frame plane holds the frame's {struct.height} rows or the "
                         f"launch's {struct.rows}, contiguous; got {tuple(t.shape)}")
    return t.data_ptr() - struct.row0 * t.stride(0) * t.element_size()


def launch(struct: MegakernelParams, color: torch.Tensor, alpha: torch.Tensor,
           tex=None, work: Optional[torch.Tensor] = None,
           depth: Optional[torch.Tensor] = None, sky=None, general: bool = False):
    """Launch the kernel for one launch struct into preallocated CUDA
    frame planes (``color`` (H, W, 3), ``alpha`` (H, W), float32) on the
    current stream of their device (:func:`library.launch`); counted in
    ``counters.megakernel_launches``.  It writes the struct's rows
    ``[row0, row0 + rows)`` only; each plane holds either the whole frame
    or just those rows (a row shard's planes).  ``tex``: ``(TexParams, shape table,
    coverage table)`` for a texture instance, ``None`` for a procedural
    field's table (also counted in ``counters.texture_launches``, and the
    general instance's, as the launcher reports it, in
    ``counters.texture_general_launches``, its tile pass in
    ``counters.tex_choice_launches``; ``general``: the general instance
    whatever the config, to compare the two).  ``work``: ``len(WORK_SLOTS) +
    len(STAGE_SLOTS)`` zeroed int64 counters that the kernel adds its work to (see
    :func:`work_counts`).  ``depth``: an (H, W) float32 plane of linear
    depth: written by a launch with the opaque pass (optional), read by a
    chained layer (``with_background``), whose ``color`` and ``alpha`` hold
    the layers below on entry and the composite on exit.  ``sky``:
    ``(TexParams, r, g, b tables)`` of the panorama sky, exactly when the
    struct's ``with_sky`` is set; the procedural instance first runs the
    sky's per-tile choice pre-pass (:func:`sky_choices`).  Returns the
    tile choices the launch made on the device: the general texture
    instance's (:func:`tex_choice_shape`, its tile pass's buffer), the sky
    pre-pass's (``(tiles, 2)``), else ``None``."""
    if bool(struct.with_sky) != (sky is not None):
        raise ValueError("a sky launch needs its (TexParams, r, g, b) pyramids, and only it")
    if struct.with_background and depth is None:
        raise ValueError("a chained layer reads the carried linear depth: depth is required")
    if not struct.with_atmosphere and depth is None:
        raise ValueError("the opaque-only pass writes the linear depth: depth is required")
    device = color.device
    blue = _BLUE_NOISE.get(str(device))
    if blue is None:
        with span("port.copy.blue_noise", device):
            blue = _BLUE_NOISE[str(device)] = blue_noise_tensor(device=device)
    lib = load_library()
    sky_params, sky_r, sky_g, sky_b = sky if sky is not None else (None, None, None, None)
    sky_ref = None if sky_params is None else ctypes.byref(sky_params)
    choices = None
    if sky is not None and tex is None:
        choices = sky_choices(struct, sky_params, device)
    scratch = None
    if tex is not None and (general or not fixed_texture_instance(struct, tex[0])):
        # the general instance's tile choices and scratch (the fixed one reads neither)
        choices = torch.empty(tex_choice_shape(struct, tex[0]), dtype=torch.int32, device=device)
        scratch = torch.empty(tex_scratch_floats(struct), dtype=torch.float32, device=device)
    instance = ctypes.c_int(-1)  # the texture instance the launcher reports
    planes = tuple(_plane_ptr(t, struct) for t in (color, alpha, depth))
    with span("port.megakernel.launch"):
        if tex is None:
            rc = library.launch(lib.megakernel_launch, color, (
                ctypes.byref(struct), sky_ref, _ptr(blue), _ptr(sky_r), _ptr(sky_g),
                _ptr(sky_b), _ptr(choices), *planes), (_ptr(work),))
        else:
            tparams, shape_table, cov_table = tex
            rc = library.launch(lib.megakernel_tex_launch, color, (
                ctypes.byref(struct), ctypes.byref(tparams), sky_ref, _ptr(blue),
                _ptr(shape_table), _ptr(cov_table), _ptr(sky_r), _ptr(sky_g), _ptr(sky_b),
                *planes), (
                _ptr(work), int(general), ctypes.byref(instance), _ptr(choices),
                0 if choices is None else choices.numel(), _ptr(scratch),
                0 if scratch is None else scratch.numel()))
    if rc != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {rc}")
    counters.megakernel_launches += 1
    if tex is None and struct.clouds_enabled and struct.with_atmosphere:
        counters.general_launches += 1
    if tex is not None:
        counters.texture_launches += 1
        if instance.value == TEX_GENERAL:
            counters.texture_general_launches += 1
            counters.tex_choice_launches += 1
    if not (struct.clouds_enabled and struct.with_atmosphere):
        counters.clear_launches += 1
    if sky is not None:
        counters.sky_launches += 1
    return choices


def tile_grid(height_rows: int, width: int) -> tuple:
    """The ``(rows, columns)`` of 32×128 tiles over ``height_rows × width``."""
    return -(-height_rows // TILE_ROWS), -(-width // TILE_COLS)


def sky_choices(struct: MegakernelParams, sky_params: TexParams, device) -> torch.Tensor:
    """Launch the sky's per-tile choice pre-pass for one launch struct on
    the current stream of ``device`` (a CUDA device): each 32×128 tile of
    the struct's rows, from ``row0``, padded past the frame, gets the level
    and mode of the panorama sky's lat-long sampler.  Returns ``(tiles, 2)``
    int32 ``(mode, level)`` rows, tiles row-major; counted in
    ``counters.sky_choice_launches``.  :func:`sky_choices_plain` is its
    plain version."""
    ty, tx = tile_grid(struct.rows, struct.width)
    out = torch.empty((ty * tx, 2), dtype=torch.int32, device=device)
    lib = load_library()
    rc = library.launch(lib.sky_choice_launch, out, (
        ctypes.byref(struct), ctypes.byref(sky_params), _ptr(out)), dtype=torch.int32)
    if rc != 0:
        raise RuntimeError(f"sky choice launch failed: CUDA error {rc}")
    counters.sky_choice_launches += 1
    return out


def sky_choices_plain(camera: Camera, height: int, width: int, meta: texsample.TexMeta,
                      row0: int = 0, rows: Optional[int] = None) -> torch.Tensor:
    """The plain version of :func:`sky_choices` for an opaque pass over
    rows ``[row0, row0 + rows)`` (default: the whole frame), on the device
    of ``camera``: the tile grid's rays from ``row0``, as the plain opaque
    pass samples the sky."""
    ty, tx = tile_grid(height - row0 if rows is None else rows, width)
    d = world_ray_dirs(camera, height, width, rows=ty * TILE_ROWS, cols=tx * TILE_COLS,
                       row0=row0)
    mode, level = texsample.sky_tile_choices(meta, d, TILE_ROWS)
    return torch.stack([mode, level], dim=1).to(torch.int32)


def tex_choice_shape(struct: MegakernelParams, tparams: TexParams) -> tuple:
    """The general texture instance's tile pass for one launch:
    ``(tiles, slots, 2)`` ``(mode, level)`` pairs, tiles row-major over the
    struct's rows from ``row0``; slot 0 the sky's (NO_CHOICE where the
    launch draws none), then each knot batch of a baked field (the
    coverage field's, the shape field's, at full quality the detail
    field's, ``knot_group`` knots each: ``texg_batches`` in the source)."""
    kg = max(tparams.knot_group, 1)
    batches = (struct.coverage_knots + kg) // kg if tparams.cov_source == SOURCE_PYRAMID else 0
    if tparams.shape_source == SOURCE_PYRAMID:
        batches += (struct.shape_knots + kg) // kg * (1 if struct.always_low else 2)
    ty, tx = tile_grid(struct.rows, struct.width)
    return ty * tx, 1 + batches, 2


def tex_scratch_floats(struct: MegakernelParams) -> int:
    """The general texture instance's scratch between its two launches, in
    floats (``texg_scratch_floats`` in the source): each launch row's
    atmosphere rgba, and TEXG_IN_PLANES per coarse pixel of the launch's
    coverage groups."""
    group = struct.cloud_lod * struct.coverage_lod
    coarse_rows = -(-struct.rows // group) * struct.coverage_lod
    return (struct.rows * 4 + TEXG_IN_PLANES * coarse_rows) * struct.width


def tex_choices_plain(params: AtmosphereParams, config: VariantConfig, camera: Camera,
                      opaque: Optional[OpaqueScene], height: int, width: int, tex_data,
                      background=None, row0: int = 0, rows: Optional[int] = None,
                      pano_meta=None) -> torch.Tensor:
    """The plain version of the general texture instance's tile choices
    (what :func:`launch` returns for it) for one texture layer over
    rows ``[row0, row0 + rows)`` (default: the whole frame), on the device
    of ``camera``: the per-tile choices the plain chain's pyramid samplers
    make (``render_frame`` with ``tex_data``, ``background`` as it takes
    them; ``texsample.record_batch_choices``), one knot batch per sampler
    call, and the sky's tile choices (:func:`sky_choices_plain`) where
    ``pano_meta`` is given (the layer draws the sky).  Raises ``ValueError``
    where the plain chain samples no knot (no pixel of the frame sees the
    cloud layer)."""
    rows = height - row0 if rows is None else rows
    with texsample.record_batch_choices() as calls:
        render_frame(params, config, camera, opaque, height, width, tex_data=tex_data,
                     background=background, row0=row0, rows=rows)
    if not calls:
        raise ValueError("the plain chain sampled no knot: no choice to compare")
    ty, tx = tile_grid(rows, width)
    device = camera.view_to_world.device
    out = torch.full((ty * tx, 1 + len(calls), 2), NO_CHOICE, dtype=torch.int32, device=device)
    if pano_meta is not None:
        out[:, 0] = sky_choices_plain(camera, height, width, pano_meta, row0=row0, rows=rows)
    for b, (mode, level) in enumerate(calls):
        out[:, 1 + b, 0] = mode.to(torch.int32)
        out[:, 1 + b, 1] = level.to(torch.int32)
    return out


def _check_table(t: Optional[torch.Tensor], meta: Optional[texsample.TexMeta], device):
    """A field's pyramid table against its meta: ``None`` exactly where
    the field has no meta (a procedural field), else a contiguous float32
    ``(meta.rows, 128)`` tensor on ``device``."""
    if meta is None or t is None:
        if (meta is None) != (t is None):
            raise ValueError("a pyramid table exactly for each field with a TexMeta "
                             "(None for a procedural field)")
        return
    if (t.device != device or t.dtype != torch.float32 or not t.is_contiguous()
            or tuple(t.shape) != (meta.rows, texsample.LANES)):
        raise ValueError(f"pyramid table must be a contiguous float32 ({meta.rows}, "
                         f"{texsample.LANES}) tensor on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _check_inputs(params: AtmosphereParams, config: VariantConfig, camera: Camera,
                  opaque: Optional[OpaqueScene], rows: int, tex_data,
                  sky: bool = False) -> tuple:
    """What the wrapper refuses, for one launch of ``rows`` rows (``sky``:
    it draws the panorama sky).  The kernel's envelope (:func:`check_config`)
    holds for CUDA tensors only: on the CPU the plain chain refuses what the
    plain ops do not take.  Returns ``(device, texture mode?)``."""
    device = camera.view_to_world.device
    if device.type == "cuda":
        check_config(config)
    devices = {params.planet_radius.device, device}
    if opaque is not None:
        devices.add(opaque.sphere_centers.device)
    if len(devices) != 1:
        raise ValueError(f"params, camera and opaque scene must share one "
                         f"device (got {sorted(map(str, devices))})")
    textured = texture_mode(config)
    if textured:
        if tex_data is None or len(tex_data) != 2:
            raise ValueError("texture mode needs tex_data = (shape, coverage) tables "
                             "(None for a procedural field)")
        _check_table(tex_data[0], config.cloud_shape_tex_meta, device)
        _check_table(tex_data[1], config.cloud_coverage_tex_meta, device)
    elif tex_data is not None:
        raise ValueError("tex_data given for a config without pyramid metas")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"megakernel runs on CUDA devices (got {device})")
    group = config.cloud_lod * config.cloud_coverage_lod if config.clouds_enabled else 1
    if device.type == "cuda" and sky and TILE_ROWS % group:
        raise ValueError(f"a sky launch needs cloud_lod·cloud_coverage_lod = {group} to "
                         f"divide the tile height {TILE_ROWS}")
    return device, textured


def _check_sky(opaque: Optional[OpaqueScene], pano_data, pano_meta, device):
    """What the wrapper refuses for the panorama sky: a panorama without its
    pyramids (on every device: the kernel's plain version samples the
    pyramids too), a meta the kernel does not take, and tables that are not
    the meta's, on the layers' device."""
    if pano_data is None:
        if opaque is not None and opaque.panorama is not None:
            raise ValueError("a panorama sky needs its pyramid tables (pano_data, pano_meta); "
                             "Scene.render builds them")
        return
    if not (isinstance(pano_meta, texsample.TexMeta) and pano_meta.kind == "latlong"
            and len(pano_meta.levels) <= MAX_LEVELS):
        raise ValueError(f"pano_meta must be a latlong TexMeta of at most {MAX_LEVELS} levels")
    if len(pano_data) != 3:
        raise ValueError("pano_data must be the (r, g, b) pyramid tables")
    for t in pano_data:
        _check_table(t, pano_meta, device)


def _check_layers(params_seq, configs, camera: Camera, opaque: Optional[OpaqueScene],
                  height: int, tex_data, bands, band_rows, pano_data=None,
                  pano_meta=None, shard=None) -> tuple:
    """What the wrapper refuses for a frame of layers, or with ``shard =
    (row0, rows)`` for a row shard of it (every layer over the shard's
    rows, layer 0 fusing the opaque pass and the sky).  Returns ``(device,
    per-layer tex_data, per-layer bands, per-layer first rows)``."""
    n = len(configs)
    if n < 1 or len(params_seq) != n:
        raise ValueError(f"{len(params_seq)} params for {n} layer configs (at least one)")
    tex = tuple(tex_data) if tex_data is not None else (None,) * n
    if shard is not None:
        bands, band_rows = (int(shard[1]),) * n, [int(shard[0])] * n
    bands = tuple(bands) if bands is not None else (None,) * n
    rows0 = ([0] * n if band_rows is None else [int(r) for r in np.asarray(band_rows)])
    if len(tex) != n or len(bands) != n or len(rows0) != n:
        raise ValueError("tex_data, bands and band_rows need one entry per layer")
    shared_reverse_z(configs)
    device = None
    sky = pano_data is not None and opaque is not None
    fused = shard is not None or bands[0] is None  # layer 0 runs the opaque pass
    for i in range(n):
        rows = height if bands[i] is None else int(bands[i])
        r0 = 0 if bands[i] is None else rows0[i]
        if r0 < 0 or rows < 1 or r0 + rows > height:
            raise ValueError(f"layer {i}: band rows [{r0}, {r0 + rows}) outside a "
                             f"{height}-row frame")
        device, _ = _check_inputs(params_seq[i], configs[i], camera,
                                  opaque if i == 0 else None, rows, tex[i],
                                  sky=sky and i == 0 and fused)
    _check_sky(opaque, pano_data, pano_meta, device)
    return device, tex, bands, rows0


def _tex_launch(config: VariantConfig, tex_data):
    return (tex_constants(config), *tex_data) if texture_mode(config) else None


def scene_launches(params_seq, configs, camera: Camera, opaque: Optional[OpaqueScene],
                   height: int, width: int, tex_data=None, bands=None,
                   band_rows=None, pano_data=None, pano_meta=None) -> list:
    """The launches of one frame, as ``(kind, struct, args)`` in launch
    order (``_chain_layers``): ``"opaque"`` (the opaque-only pass, when
    layer 0 is banded), ``"layer"`` (a fullscreen layer: layer 0 fuses the
    opaque pass, later ones composite over the frame) and ``"band"`` (a
    chained layer over its row band); ``args`` holds the :func:`launch`
    keywords ``tex`` and ``sky``.  The launch that runs the opaque pass
    draws the panorama sky (``pano_data``, ``pano_meta``)."""
    n = len(configs)
    tex = tex_data or (None,) * n
    bands = bands or (None,) * n
    sky = _sky_launch(pano_data, pano_meta) if opaque is not None else None
    out = []
    if bands[0] is None:
        s = frame_constants(params_seq[0], configs[0], camera, opaque, height, width)
        out.append(("layer", s, dict(tex=_tex_launch(configs[0], tex[0]), sky=sky)))
        start = 1
    else:
        s = frame_constants(params_seq[0], opaque_only_config(configs[0]), camera, opaque,
                            height, width)
        s.with_atmosphere = 0
        out.append(("opaque", s, dict(tex=None, sky=sky)))
        start = 0
    s.with_sky = int(sky is not None)
    for i in range(start, n):
        s = frame_constants(params_seq[i], configs[i], camera, None, height, width)
        s.with_background = 1
        if bands[i] is not None:
            s.row0, s.rows = int(band_rows[i]), int(bands[i])
        out.append(("layer" if bands[i] is None else "band", s,
                    dict(tex=_tex_launch(configs[i], tex[i]), sky=None)))
    return out


def render_scene_megakernel(params_seq, configs, camera: Camera,
                            opaque: Optional[OpaqueScene], height: int, width: int,
                            tex_data=None, bands=None, band_rows=None, pano_data=None,
                            pano_meta=None) -> dict:
    """Render one frame of layers (far to near): ``{"color": (H, W, 3),
    "alpha": (H, W)}``.

    ``tex_data``: per layer its ``(shape, coverage)`` pyramid tables (a
    texture-mode config) or ``None``; ``bands``: per layer ``None``
    (fullscreen) or its band height, ``band_rows`` its first row
    (``Scene._layer_bands``); ``pano_data``/``pano_meta``: the panorama
    sky's (r, g, b) pyramid tables and meta (required when the opaque
    scene has a panorama).  CPU tensors take the plain chain; CUDA tensors
    launch the kernel once per layer, plus the opaque-only pass when layer
    0 is banded, on one stream into preallocated planes, with nothing
    between the launches; any other device raises."""
    device, tex, bands, rows0 = _check_layers(params_seq, configs, camera, opaque, height,
                                              tex_data, bands, band_rows, pano_data, pano_meta)
    if device.type == "cpu":
        out = render_scene_plain(params_seq, configs, camera, opaque, height, width,
                                 tex_data=tex, bands=bands, band_rows=rows0,
                                 pano_data=pano_data, pano_meta=pano_meta)
        return {"color": out["color"], "alpha": out["alpha"]}
    plan = scene_launches(params_seq, configs, camera, opaque, height, width, tex_data=tex,
                          bands=bands, band_rows=rows0, pano_data=pano_data,
                          pano_meta=pano_meta)
    color = torch.empty((height, width, 3), dtype=torch.float32, device=device)
    alpha = torch.empty((height, width), dtype=torch.float32, device=device)
    depth = (torch.empty((height, width), dtype=torch.float32, device=device)
             if len(plan) > 1 else None)
    for _, struct, args in plan:
        launch(struct, color, alpha, depth=depth, **args)
    return {"color": color, "alpha": alpha}


def render_frame_megakernel(params: AtmosphereParams, config: VariantConfig,
                            camera: Camera, opaque: Optional[OpaqueScene],
                            height: int, width: int, tex_data=None, pano_data=None,
                            pano_meta=None) -> dict:
    """Render one fullscreen layer over the opaque pass: ``{"color":
    (H, W, 3), "alpha": (H, W)}`` (:func:`render_scene_megakernel` of one
    layer).  A texture-mode config needs ``tex_data``, its ``(shape,
    coverage)`` pyramid tables; a panorama its ``pano_data``, ``pano_meta``."""
    return render_scene_megakernel((params,), (config,), camera, opaque, height, width,
                                   tex_data=(tex_data,), pano_data=pano_data,
                                   pano_meta=pano_meta)


# -- row shards (K1 slice (g)) ----------------------------------------------------


def _as_band(s: MegakernelParams, layer: int, row0: int, rows: int, sky: bool):
    """Set a layer's launch struct to a row shard's rows: layer 0 fuses the
    opaque pass (and draws the sky), every later layer is chained."""
    s.row0, s.rows = int(row0), int(rows)
    s.with_background = int(layer > 0)
    s.with_sky = int(layer == 0 and sky)


def band_launches(params_seq, configs, camera: Camera, opaque: Optional[OpaqueScene],
                  height: int, width: int, row0: int, rows: int, tex_data=None,
                  pano_data=None, pano_meta=None) -> list:
    """The launches of rows ``[row0, row0 + rows)`` of a frame, a row
    shard's share (``render_scene_band_pallas``), as ``(kind, struct,
    args)`` with kind ``"band"``, one per layer in launch order: layer 0
    fuses the opaque pass and draws the panorama sky (``pano_data``,
    ``pano_meta``) over the shard's rows, every later layer composites over
    them.  No opaque-only pass and no per-layer far band: the shard split
    takes their place."""
    n = len(configs)
    tex = tex_data or (None,) * n
    sky = _sky_launch(pano_data, pano_meta) if opaque is not None else None
    out = []
    for i in range(n):
        s = frame_constants(params_seq[i], configs[i], camera, opaque if i == 0 else None,
                            height, width)
        _as_band(s, i, row0, rows, sky is not None)
        out.append(("band", s, dict(tex=_tex_launch(configs[i], tex[i]),
                                    sky=sky if i == 0 else None)))
    return out


def band_flight_launches(params_seq, fs_stacks, configs, camera: Camera,
                         opaque: Optional[OpaqueScene], height: int, width: int,
                         cam_stack: np.ndarray, shards, tex_data=None, pano_data=None,
                         pano_meta=None) -> list:
    """Every K1 launch of a row-sharded flight, on the host:
    ``launches[frame][shard]`` is the list of ``(struct, args)`` of
    :func:`band_launches` for ``shards[shard] = (row0, rows)``, from the
    per-layer (K, 24) frame states and (K, 4, 4) transforms, as
    :func:`flight_constants` patches them."""
    n = len(configs)
    tex = tex_data or (None,) * n
    sky = _sky_launch(pano_data, pano_meta) if opaque is not None else None
    structs = [flight_constants(p, c, camera, opaque if i == 0 else None, height, width, fs,
                                cam_stack)
               for i, (p, c, fs) in enumerate(zip(params_seq, configs, fs_stacks))]
    args = [dict(tex=_tex_launch(c, t), sky=sky if i == 0 else None)
            for i, (c, t) in enumerate(zip(configs, tex))]
    out = []
    for f in range(len(cam_stack)):
        frame = []
        for row0, rows in shards:
            shard = []
            for layer in range(n):
                s = MegakernelParams.from_buffer_copy(structs[layer][f])
                _as_band(s, layer, row0, rows, sky is not None)
                shard.append((s, args[layer]))
            frame.append(shard)
        out.append(frame)
    return out


def render_scene_band_plain(params_seq, configs, camera: Camera,
                            opaque: Optional[OpaqueScene], height: int, width: int, row0: int,
                            band_height: int, tex_data=None, pano_data=None,
                            pano_meta=None) -> dict:
    """The row shard's plain PyTorch version (``renderer.py::
    render_scene_band``, counted once in ``counters.plain_calls``); runs on
    any device."""
    counters.plain_calls += 1
    return render_scene_band(params_seq, configs, camera, opaque, height, width, row0,
                             band_height, tex_data=tex_data, pano_data=pano_data,
                             pano_meta=pano_meta)


def render_scene_band_megakernel(params_seq, configs, camera: Camera,
                                 opaque: Optional[OpaqueScene], height: int, width: int,
                                 row0: int, band_height: int, tex_data=None, pano_data=None,
                                 pano_meta=None) -> dict:
    """Rows ``[row0, row0 + band_height)`` of the far→near layer chain, the
    counterpart of ``render_scene_band_pallas``: ``{"color": (band_height,
    W, 3), "alpha": (band_height, W), "linear_depth": (band_height, W)}``
    (linear depth: the opaque pass's).  Arguments as in
    :func:`render_scene_megakernel`, without bands.  CPU tensors take the
    plain version; CUDA tensors launch the kernel once per layer
    (:func:`band_launches`) into planes of the shard's rows; any other
    device raises."""
    device, tex, _, _ = _check_layers(params_seq, configs, camera, opaque, height, tex_data,
                                      None, None, pano_data, pano_meta,
                                      shard=(row0, band_height))
    if device.type == "cpu":
        return render_scene_band_plain(params_seq, configs, camera, opaque, height, width,
                                       row0, band_height, tex_data=tex, pano_data=pano_data,
                                       pano_meta=pano_meta)
    f32 = dict(dtype=torch.float32, device=device)
    out = {"color": torch.empty((band_height, width, 3), **f32),
           "alpha": torch.empty((band_height, width), **f32),
           "linear_depth": torch.empty((band_height, width), **f32)}
    for _, struct, args in band_launches(params_seq, configs, camera, opaque, height, width,
                                         row0, band_height, tex_data=tex,
                                         pano_data=pano_data, pano_meta=pano_meta):
        launch(struct, out["color"], out["alpha"], depth=out["linear_depth"], **args)
    return out


def render_band_megakernel(params: AtmosphereParams, config: VariantConfig, camera: Camera,
                           opaque: Optional[OpaqueScene], height: int, width: int, row0: int,
                           band_height: int, tex_data=None, pano_data=None,
                           pano_meta=None) -> dict:
    """Rows ``[row0, row0 + band_height)`` of one layer over the fused
    opaque pass, the counterpart of ``render_band_pallas``
    (:func:`render_scene_band_megakernel` of one layer)."""
    return render_scene_band_megakernel((params,), (config,), camera, opaque, height, width,
                                        row0, band_height, tex_data=(tex_data,),
                                        pano_data=pano_data, pano_meta=pano_meta)


def render_flight_megakernel(params_seq, fs_stacks, configs, camera: Camera,
                             opaque: Optional[OpaqueScene], height: int, width: int,
                             cam_stack=None, tex_data=None, pano_data=None,
                             pano_meta=None) -> dict:
    """Render K frames of a flight: ``{"color": (K, H, W, 3), "alpha":
    (K, H, W)}``.

    ``params_seq``/``configs``: the layers, far to near, each rendered
    fullscreen; ``fs_stacks``: per layer (K, 24) host rows of packed frame
    state (``PlanetAtmosphere.frame_state_row``); ``cam_stack``: optional
    (K, 4, 4) host ``view_to_world`` transforms (default: ``camera``'s for
    every frame); ``tex_data``, ``pano_data``, ``pano_meta``: as in
    :func:`render_scene_megakernel`.  CPU tensors take the plain flight;
    CUDA tensors compute every frame's launch structs on the host, then
    launch the kernel once per layer and frame back to back into
    preallocated outputs.
    """
    return _flight(params_seq, fs_stacks, configs, camera, opaque, height, width, cam_stack,
                   tex_data, None, pano_data, pano_meta)


def render_flight_taa(params_seq, fs_stacks, configs, camera: Camera,
                      opaque: Optional[OpaqueScene], height: int, width: int,
                      cam_stack=None, blend: float = 0.15, tex_data=None,
                      depth_eps: float = 0.2, clamp_mode: str = "minmax",
                      clamp_gamma: float = 1.25, pano_data=None, pano_meta=None) -> dict:
    """The temporally accumulated flight: as :func:`render_flight_megakernel`,
    but each output frame is the TAA resolve (``taa.py``) of the frame
    rendered with temporal jitter (forced on) against the previous resolved
    frame, with the chain's linear depth (layer 0's opaque pass).  Frame 0
    resolves with blend 1.0 against zero history at depth 1e7; the returned
    alpha is each raw frame's.  On a card every frame is one K1 launch per
    layer and one K3 launch."""
    configs = tuple(dataclasses.replace(c, temporal_jitter=True) for c in configs)
    settings = taa.TaaSettings(float(blend), float(depth_eps), clamp_mode, float(clamp_gamma))
    return _flight(params_seq, fs_stacks, configs, camera, opaque, height, width, cam_stack,
                   tex_data, settings, pano_data, pano_meta)


def _flight(params_seq, fs_stacks, configs, camera, opaque, height, width, cam_stack, tex_data,
            settings: Optional[taa.TaaSettings], pano_data, pano_meta) -> dict:
    device, tex, _, _ = _check_layers(params_seq, configs, camera, opaque, height, tex_data,
                                      None, None, pano_data, pano_meta)
    fs_stacks = [np.ascontiguousarray(fs, np.float32) for fs in fs_stacks]
    k = fs_stacks[0].shape[0]
    if cam_stack is None:
        with span("port.copy.flight_view", camera.view_to_world.device):
            vtw = camera.view_to_world.detach().cpu().numpy()
        cam_stack = np.broadcast_to(vtw, (k, 4, 4))
    cam_stack = np.ascontiguousarray(cam_stack, np.float32)
    if (len(fs_stacks) != len(configs) or k < 1 or cam_stack.shape != (k, 4, 4)
            or any(fs.shape != (k, 24) for fs in fs_stacks)):
        raise ValueError(f"a flight needs per layer (K, 24) frame states and (K, 4, 4) "
                         f"transforms, got {[fs.shape for fs in fs_stacks]} and "
                         f"{cam_stack.shape}")
    if settings is not None:
        taa.check_shapes(height, height, width, settings.clamp_mode)
    if device.type == "cpu":
        counters.plain_calls += k
        if settings is not None:
            taa.counters.plain_calls += k
        return render_flight_plain(params_seq, fs_stacks, configs, camera, opaque, height,
                                   width, cam_stack=cam_stack, tex_data=tex, taa=settings,
                                   pano_data=pano_data, pano_meta=pano_meta)

    # every launch struct on the host first: no device->host copy from the
    # first launch to the last
    structs = [flight_constants(p, c, camera, opaque if i == 0 else None, height, width, fs,
                                cam_stack)
               for i, (p, c, fs) in enumerate(zip(params_seq, configs, fs_stacks))]
    for layer in structs[1:]:
        for s in layer:
            s.with_background = 1
    sky = _sky_launch(pano_data, pano_meta) if opaque is not None else None
    for s in structs[0]:
        s.with_sky = int(sky is not None)
    args = [dict(tex=_tex_launch(c, t), sky=sky if i == 0 else None)
            for i, (c, t) in enumerate(zip(configs, tex))]
    n = len(configs)
    f32 = dict(dtype=torch.float32, device=device)
    color = torch.empty((k, height, width, 3), **f32)
    alpha = torch.empty((k, height, width), **f32)
    depth = torch.empty((height, width), **f32) if n > 1 or settings is not None else None
    if settings is None:
        for i in range(k):
            for layer in range(n):
                launch(structs[layer][i], color[i], alpha[i], depth=depth, **args[layer])
        return {"color": color, "alpha": alpha}
    resolves = taa.flight_constants(camera, cam_stack, settings, height, width)
    raw = torch.empty((height, width, 3), **f32)
    no_history = torch.zeros((height, width, 3), **f32)
    # history depth ping-pong: frame i reads depths[i % 2], writes the other
    depths = (torch.full((height, width), taa.DEPTH_CLAMP, **f32),
              torch.empty((height, width), **f32))
    for i in range(k):
        for layer in range(n):
            launch(structs[layer][i], raw, alpha[i], depth=depth, **args[layer])
        taa.launch(resolves[i], raw, depth, color[i - 1] if i else no_history,
                   depths[i % 2], color[i], depths[(i + 1) % 2])
    return {"color": color, "alpha": alpha}


def work_counts(struct: MegakernelParams, color: torch.Tensor, alpha: torch.Tensor,
                tex=None, depth: Optional[torch.Tensor] = None, sky=None,
                stages: bool = False, general: bool = False) -> dict:
    """One launch with the kernel's work counters on: how many pixels,
    atmosphere integrations (v2 and v1) and v2 sun-depth quadrature
    segments, knot groups, marched coarse pixels, sun-march samples,
    texture samples (trilinear or bilinear, and floor-mode nearest),
    opaque-only pixels and sky samples (three-channel bilinear, and
    floor-mode nearest) this launch's inputs needed, and the procedural
    march's warp- and lane-steps.  ``stages``: add the
    measurement build's per-stage cycles (:data:`STAGE_SLOTS`, keys
    ``stage_<name>_cycles``; zeros from the normal build).  ``general``:
    as :func:`launch` takes it.  Counted in the launch counters like any
    launch; a chained layer composites over ``color`` again."""
    # the measurement build writes its stage slots after the work slots
    work = torch.zeros(len(WORK_SLOTS) + len(STAGE_SLOTS), dtype=torch.int64,
                       device=color.device)
    launch(struct, color, alpha, tex=tex, work=work, depth=depth, sky=sky, general=general)
    counts = work.cpu().tolist()
    out = dict(zip(WORK_SLOTS, counts))
    if stages:
        out.update((f"stage_{name}_cycles", n)
                   for name, n in zip(STAGE_SLOTS, counts[len(WORK_SLOTS):]))
    return out


# -- K2 alone -------------------------------------------------------------------

#: ``texsample_kernel``'s threads a block, the samples of a batch it keeps
#: in shared memory, and the texels of a batch's box it copies there
#: (``TS_THREADS``, ``TS_KEEP``, ``TS_BOX`` in megakernel.cu)
TEXSAMPLE_THREADS, TEXSAMPLE_KEEP, TEXSAMPLE_BOX = 512, 8192, 4096


def texsample_plan(batches: int, n: int, aligned: bool, shape: bool = True) -> dict:
    """How ``texsample_kernel`` takes ``batches`` batches of ``n`` samples:
    one block of :data:`TEXSAMPLE_THREADS` a batch; 16-byte loads and
    stores, four samples at once, where ``n % 4 == 0`` and every plane is
    16-byte ``aligned`` (``vector``), else one sample at once; a batch of at
    most :data:`TEXSAMPLE_KEEP` samples read once and kept on chip (3
    floats a sample for ``tex3d``, 2 for ``latlong``), a longer one read
    twice; ``smem_bytes``: the kept samples and the box of
    :data:`TEXSAMPLE_BOX` texels the lookups gather from (the kernel fills
    it where the batch's texels fit).  ``samples_per_thread``: the most any
    thread takes."""
    vector = aligned and n % 4 == 0
    width = 4 if vector else 1
    keep = n <= TEXSAMPLE_KEEP
    return {"blocks": batches, "threads": TEXSAMPLE_THREADS, "vector": vector,
            "samples_per_thread": width * -(-n // (width * TEXSAMPLE_THREADS)),
            "reads": 1 if keep else 2,
            "smem_bytes": 4 * (((3 if shape else 2) * n if keep else 0) + TEXSAMPLE_BOX)}


def sample_batches(table: torch.Tensor, meta: texsample.TexMeta, a, b, c,
                   window_rows: int = 16, band_rows: int = 16,
                   band_max_slices: int = 32) -> tuple:
    """K2 on caller-given batches: ``a, b, c`` are ``(B, N)`` float32
    planes, one batch per row — coordinates in periods for a ``tex3d``
    pyramid, unit directions for a ``latlong`` one.  Returns ``(values
    (B, N), mode (B,), level (B,))``.  CPU tensors take the plain samplers;
    CUDA tensors launch the kernel's device functions (counted in
    ``counters.texsample_launches``), as :func:`texsample_plan` says."""
    device = a.device
    if any(t.shape != a.shape or t.dim() != 2 or t.device != device for t in (a, b, c)):
        raise ValueError("a, b, c must be (B, N) planes on one device")
    shape = meta.kind == "tex3d"
    if device.type == "cpu":
        if shape:
            return texsample._tex3d_batches(table.reshape(-1), meta, a, b, c, window_rows,
                                            band_rows, band_max_slices)
        return texsample._latlong_batches(table.reshape(-1), meta, texsample.Vec3(a, b, c),
                                          window_rows)
    if device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA devices (got {device})")
    _check_table(table, meta, device)
    a, b, c = (t.to(torch.float32).contiguous() for t in (a, b, c))
    cfg = VariantConfig(texture_window_rows=window_rows, texture_band_rows=band_rows,
                        texture_band_max_slices=band_max_slices)
    tparams = (tex_constants(cfg, shape=meta) if shape
               else tex_constants(cfg, coverage=meta))
    out = torch.empty_like(a)
    choice = torch.empty((a.shape[0], 2), dtype=torch.int32, device=device)
    plan = texsample_plan(a.shape[0], a.shape[1],
                          not any(t.data_ptr() % 16 for t in (a, b, c, out)), shape)
    rc = library.launch(load_library().texsample_launch, out, (
        ctypes.byref(tparams), int(shape), _ptr(table), _ptr(a), _ptr(b), _ptr(c), a.shape[0],
        a.shape[1], int(plan["vector"]), _ptr(out), _ptr(choice)))
    if rc != 0:
        raise RuntimeError(f"texsample launch failed: CUDA error {rc}")
    counters.texsample_launches += 1
    return out, choice[:, 0].long(), choice[:, 1].long()
