"""GPU smoke run of the PyTorch/CUDA port's main paths.

Renders the demo scene through the port (``godot_atmosphere_shader_tpu_torch``)
on one CUDA card and checks every step:

1. device: a CUDA card must be present; prints its ``nvidia-smi`` name and
   power limit;
2. build: compiles the port's kernels (``csrc/megakernel.cu``, ``taa.cu``,
   ``probes.cu``, one ``nvcc`` each, started together, then linked into one
   library) for ``sm_90a`` and prints the compiler's register report;
3. kernel against plain, small: at 256×384, ``no_clouds``/avatar,
   ``clouds``/avatar, ``clouds_high``/avatar and ``clouds_high``/interior
   through the kernel and through its plain PyTorch version on the same
   CUDA inputs (cloud tolerance: p99.9 |Δ| ≤ 1e-3, mean |Δ| ≤ 1e-4, at most
   0.1 % of pixels above 1e-2);
3b. texture mode, small: K2 alone (``megakernel.sample_batches``) against
   the plain samplers on the planes of ``tests/test_torch_texsample.py``
   (same mode and level, atol 2e-6); then the ``clouds_high`` texture scene
   (textures baked on the card) at avatar and interior, 256×384, kernel
   against plain at the cloud tolerance;
3c. flight mode, small: the TAA resolve K3 alone at 1080×1920 against its
   plain version on the cases of ``tests/test_torch_taa.py`` (max |Δ| ≤ 1e-4
   where validity agrees, validity flips ≤ 0.01 % of pixels); a 4-frame TAA
   flight at 256×384 through ``Scene.render_flight`` against the plain
   flight, frame by frame (cloud tolerance);
4. the procedural slice at 1080p: ``Scene.render`` for
   ``clouds_high``/avatar, ``clouds_high``/interior and ``clouds``/avatar,
   with the launch counters showing that every frame went through the
   kernel and none through the plain path.  Each frame is then held against
   the plain version on the same inputs (cloud tolerance), and
   ``clouds_high``/avatar also against the committed 1080p block signature
   ``tests/golden_1080p_sig.npz`` (block mean ≤ 3e-3, block max ≤ 3e-2);
4b. the texture slice at 1080p: ``Scene.render`` of the ``clouds_high``
   texture scene at avatar (the JAX bench cell 6) and interior, through the
   texture instance only (counters), each held against the plain version
   (cloud tolerance); the one-off bake and pyramid times; the card's bake
   against the port's CPU bake at 16³ and 32² faces (atol 1e-5);
5. timing at 1080p with CUDA events: kernel launches alone, ``Scene.render``
   end to end (``update`` per frame) and the plain version; the device's
   idle share during ``Scene.render`` from a ``torch.profiler`` trace;
6. the flight slice at 1080p: three 8-frame flights through
   ``Scene.render_flight`` along a fly path from the avatar pose (forward at
   10 units/s with a small yaw, 1/60 s per frame): procedural
   ``clouds_high`` with TAA (blend 0.15), texture ``clouds_high`` with TAA,
   procedural without TAA.  Counters: 8 K1 launches per flight, 8 K3
   launches per TAA flight, no plain call; every frame held against the
   plain flight on the same CUDA inputs (cloud tolerance); a
   ``torch.profiler`` trace shows no device→host copy between a flight's
   first launch and its last;
7. flight timing: each flight's ms per frame end to end, its host ms per
   frame and the device's idle share; K3 alone at 1080p with its bound, its
   events and device time (``torch.profiler``) and what it uses
   (``taa.info``: CTAs per tile, registers, stack, CTAs per SM, shared
   memory); the launch floor T3 (``probes.py``'s fill kernel, launched back
   to back, its events and device time, ``fill_`` in turns with it; both replayed
   from a CUDA graph of the K launches) and the launch route's host cost
   step by step, the old route beside the one every launcher takes
   (``library.launch``); K2 alone (T1) on 1080p-sized batches of both
   kinds against the plain samplers (same mode and level in every batch,
   atol 2e-6), with its events and device ms, the wrapper's host ms per
   call and its bound.

The exterior and multi-planet frames (far-mode row bands, the opaque-only
pass, the far→near layer chain, v1, raymarched cloud lighting) run in three
more phases:

3d. small (256×384), kernel against plain at the cloud tolerance, with the
   launch counters (one K1 launch per kept layer, one more when the
   opaque-only pass runs, no plain call): the opaque-only pass alone,
   ``v1_no_clouds``/exterior, ``no_clouds``/exterior, ``clouds``/space, the
   JAX bench cell 5 scene (``clouds_high_rm`` and the moon's ``no_clouds``
   atmosphere) and the golden's chain (a ``v1_no_clouds`` moon) at space, a
   far-mode ``clouds_high`` texture layer at space, and a 4-frame two-layer
   TAA flight against the plain flight (K1 = 2·K, K3 = K launches);
4c. the JAX bench cells 1 (``v1_no_clouds``/exterior, 256²), 2
   (``no_clouds``/exterior, 512²), 5 (cell 5's scene at space, 1080p) and 7
   (the gas giant at its limb pose, 1080p) through ``Scene.render``, each
   with its band plan and held against the plain chain;
5b. per cell: kernel ms per launch (opaque-only, fullscreen or banded
   layer; events, and device time from ``torch.profiler``; a cloud-free
   launch with what ``megakernel_clear`` uses, ``mk.clear_info``) with each
   launch's roofline bound from its work counters (the atmosphere per step
   of the layer's config and per quadrature segment evaluated),
   ``Scene.render`` ms and idle share, plain ms; on cell 5 the frame with
   ``bands=None`` forced and the planet band without raymarched lighting.

The panorama sky (K1 slice (f): the launch that runs the opaque pass
samples three channel pyramids, one level and mode per 32×128 tile; the
procedural instance and the opaque-only pass read the tiles' choices from
the pre-pass ``sky_choice_kernel``) and the glow output stage run in three
more phases, with a synthetic 1024×2048 panorama made from a seed:

3e. small (256×384), kernel against plain at the cloud tolerance, with the
   counters (the planned K1 launches, one of them drawing the sky, one
   pre-pass unless the texture instance draws it, no plain call and no call
   of the plain sky sampler): the opaque-only pass with the sky alone;
   ``no_clouds``, procedural ``clouds_high`` and texture ``clouds_high`` at
   avatar, each fused with the sky; the everything-on frame
   (``tools/tpu_checks.py:318-342``: texture clouds, the check's own 32×64
   panorama, a far-mode moon) at avatar, also against
   ``tests/golden_allon_sig.npz``, and at space (the opaque-only pass draws
   the sky), then both again with the seeded star panorama, whose stars
   show a wrong level; a 4-frame TAA flight with the sky;
4d. 1080p through ``Scene.render``: the everything-on frame at avatar and
   at space and ``clouds_high`` at avatar and at sunward, each with the
   1024×2048 panorama and held against the plain chain; the pre-pass alone
   against its plain version on each of these frames (the same mode and
   level in every tile); then ``Scene.apply_environment`` with
   ``GlowSettings.demo()`` on the card against the plain glow of the CPU
   copy (atol 1e-5), on the everything-on frame (no pixel over the
   threshold: the glow adds nothing there) and on the sunward frame, whose
   HDR sun disc must bloom;
5c. per frame: kernel ms per launch with its bound, each sky launch also
   with the sky off (the sky's cost), ``Scene.render`` ms and idle share,
   plain ms, glow ms; the pre-pass alone (events and device time) and its
   plain version; the opaque-only pass's plain ms.

Row-sharded rendering (K1 slice (g): the band entries, layer 0 fusing the
opaque pass and the sky over a shard's rows; K3's band mode; the sharded
TAA flight with its halo exchange; n > 1 shards on one card are the local
mesh, ``parallel/sharding.py``) runs in three more phases:

3f. small (256×384, 2 shards): procedural and texture ``clouds_high`` with
   the sky at avatar and the everything-on frame at avatar and space
   through the band entries, each shard against its plain version (cloud
   tolerance) with the counters (one K1 launch per layer and shard, one sky
   launch and pre-pass per shard unless the texture instance draws the
   sky, no plain call), each shard's pre-pass against
   ``sky_choices_plain(row0=)`` (the same choice in every tile), the
   assembled frame against ``Scene.render``; a 4-frame sharded TAA flight
   with the sky against the plain sharded flight (K1 and K3 2·K launches);
4e. 1920×1024 on 4 shards: the everything-on frame
   (``render_scene_megakernel_sharded``) and an 8-frame sharded TAA flight
   (``Scene.render_flight(mesh=)``, the phase 6 fly path), each against its
   plain version and the single-card frame or flight (cloud tolerance, max
   recorded), and ``clouds_high``/avatar at 1080p on 2 shards of 540 rows;
   the main path's counters (n K1 launches per layer, n sky launches and
   pre-passes; the flight K·n K1 and K·n K3; no plain call);
   ``torch.distributed`` world size 1 on NCCL against the local mesh of one
   shard, bit for bit; K3's band mode alone on 4 shards with a 32-row halo,
   bit-equal to its plain version and, put together, to the full-frame K3,
   with its ms per shard (events and device time) and bound;
5d. per-shard K1 ms with bounds from the work counters, the sharded
   frame's kernel ms against the single-card frame's, the plain band
   chain's ms, the sharded flight's ms per frame, host ms and idle share.

K1's procedural envelope (slice (h): the procedural instance, every noise
basis and fractal, per-step fields, the detail field, any knot count and
LOD group) and the peak probe T2 run in four more phases:

7b. (run right after the build: every bound divides by its rates) T2's
   fma, expf, __expf and uint32 multiply-add chains against their plain
   version (fmaf against a multiply then an add: atol 1e-5; expf 1e-5;
   __expf 1e-4; uint32 exact), then timed on the card, every timed launch
   held against the plain chains at its own iteration count: the fp32
   FLOP/s (an FMA is 2), exp/s, __expf/s and INT32 instructions/s beside
   the ceilings at the SM clock sampled under load (with power and limit)
   and the data sheet's 67 TFLOP/s; the bounds divide by the larger of
   the measured rate and the clock's ceiling (fp32 and int32 operations
   apart);
3g. small (256×384): 26 envelope configs on the demo scene (each basis
   as shape and as coverage, cellular with its three returns; ping-pong;
   weighted fbm, ridged, ping-pong; coverage
   K = 4, 16; shape knots K_s = 8, 16, 32; full quality with shape and
   detail knots under cheap and raymarched light; LOD groups of 16 and 32
   rows, the 16-row one also over 248 rows, its last group partial; the
   demo profile's hat-sum twin) through ``Scene.render`` (one K1
   launch of the procedural instance, no plain call) against plain: the cloud
   tolerance, at full quality the detail tolerance (p99 for p99.9), whose
   reason is measured first: the plain frame against itself with the
   camera one ulp away; then shape knots over 32-row coverage groups
   (``KNOT_GROUP_CASES``) under the cloud tolerance, or the knot-group
   tolerance where its reason, measured first, holds: the plain frame
   against itself with every march span one ulp longer leaves the cloud
   tolerance;
4f. 1080p through ``Scene.render``: the cellular tier, the reference
   shader's per-step profile, the ``.tscn`` importer's profile and full
   quality (4 procedural-instance launches, no plain call), each against
   the whole plain frame;
5e. per 4f frame: kernel ms with its bound (work counters under the
   ceilings of 7b), ``Scene.render`` ms and idle share, the plain frame's
   ms;
5f. the procedural instance ``megakernel_gen<C>``: what each instance
   uses (registers, stack, resident blocks per SM, shared memory, row
   cache); per 1080p frame of phases 4-4f (and the flagship's 2 shards of
   5d) each procedural launch's march lane utilisation and, through the
   measurement build (``-DMK_STAGE_CLOCKS``, built beside the package's),
   its cycles per stage (coarse pass, knots, march, blend); the same for
   the texture instance ``megakernel_tex<G>`` (``mk.tex_info``) on the
   texture frames of 4b and the everything-on frame of 4d, and the general
   texture instance (its tile pass's stages and its frame's) on the
   frames of 4g and bench cell 6 asked of it; every such launch's work
   counts held against the previous design's (``PARENT_WORK``,
   ``PARENT_TEX_WORK``, ``PARENT_TEXG_WORK``; the texture launches of 4e's
   4 shards too), so the bounds are shown not to move.

K1's texture envelope (slice (i): the general texture instance
``megakernel_tex_general``, a baked field beside a procedural one, full
quality, any knot count, knot group and LOD group) and the gas giant's
card check run in three more phases:

3h. small (64×128): first what one ulp moves the plain frame by (full
   quality: the camera one ulp along z; coverage groups of 32 rows: every
   march span one ulp longer); then 19 texture configs
   (``TEX_ENVELOPE_CASES``: shape baked beside procedural coverage knots
   and per-step coverage, procedural shape knots and per-step shape beside
   baked coverage, full quality under cheap and raymarched light, coverage
   K = 4, 16, shape knots 8, 32, G = 1, 2, 16, 32, knot groups 1 and 17,
   a 9-level shape pyramid) through ``Scene.render`` (one launch of a
   texture instance, no plain call; the general instance with its tile
   choice) against plain: the cloud tolerance, the detail or knot-group
   tolerance only where that measurement fails it; and each case's tile
   choices, as a launch of the general instance returns them, against
   their plain version (``mk.tex_choices_plain``), exactly;
3i. the gas giant's 192×128 limb band (cell 7's scene): the kernel, the
   plain chain on the card and on the CPU, and the JAX XLA frame
   (``tests/golden_gas_giant_xla.npz``), every pair under the gas-giant
   golden's statistics, and each frame against itself with the camera one
   ulp along z; the kernel held to the golden's budget against all three,
   its largest |Δ| 1e-3 where one ulp moves the plain frames out of it;
4g. 1080p through ``Scene.render``: the texture reference profile (G = 1),
   texture full quality, baked shape beside procedural coverage knots and
   procedural per-step shape beside baked coverage (4 launches of the
   general instance, each with its tile pass, no plain call), each
   against the whole plain frame and its launch's tile choices against
   their plain version (exact), then timed: the two launches' ms by
   events, each one's device time, each one's bound from the work counters
   (each charged with what it runs) and the two launches' together,
   ``Scene.render`` ms and idle share, the plain ms, the instance's
   registers, stack and blocks per SM; and bench cell 6 through both texture instances (the general one asked
   for, ``mk.launch(general=True)``), timed and compared.

K1 sized per scene (every sphere, box and octave past the launch struct's
inline 8, 4 and 8 in the scene's buffer on the card), the command line,
the Godot scene importer, large worlds and the optical-depth LUT run in
two more phases:

3j. small: 64×128 frames with 1, 8, 9, 16 and 33 spheres, 4, 5 and 12
   boxes and 8, 9 and 10 octaves and warp octaves (``GEOMETRY_CASES``),
   each through the procedural, cloud-free, fixed texture and general
   texture instance (``renderer="kernel"``, counters: that instance once,
   no plain call) against ``renderer="plain"``: cloud-free at atol 1e-5,
   rtol 1e-4, the others at the cloud tolerance, their fields on
   ``GEOMETRY_CHAINS`` after measuring why (``geometry_conditioning``:
   with the demo's lacunarities one ulp of the camera moves these frames
   as far as kernel and plain lie apart; with these it does not, and two
   octaves fewer do); the 256² optical-depth
   bake on the card against the CPU's (atol 1e-6 × its maximum), timed;
   ``clouds`` with ``od_mode="lut"`` at 256×384: ``renderer="auto"``
   takes the plain route on the card (no K1 launch), held against the
   CPU's frame at the cloud tolerance, and ``renderer="kernel"`` raises;
3k. the GPU gate (``godot_atmosphere_shader_tpu_torch/tools/gpu_checks.py``,
   the twin of the JAX package's ``tools/tpu_checks.py``) at 256×384 in
   this process, with the run's baked textures: the seven variant poses
   through ``Scene.render`` against plain (p99.9 ≤ 1e-3, max ≤ 4e-3, or
   the tolerance one ulp of the camera keeps), texture mode against exact
   sampling, the banded sampler, the sharded band (Δ = 0), the 1080p and
   everything-on signatures and the sharded everything-on frame; each
   result on a line of its own, any failure fails the run;
7c. (after phase 7) the band-fidelity tool
   (``godot_atmosphere_shader_tpu_torch/tools/measure_band_fidelity.py``)
   at the interior pose: each of the 1530 batches' level, windowed alone
   and banded, K2's choice equal to the plain one in every batch whose
   pixels all hit, the field error of K2 with ``band_rows`` 0 and 16
   against exact trilinear on the first 16 engaged batches and on every
   one (K2 against the plain samplers at atol 2e-6, the same mode and
   level), then K2 alone timed on the tool's batches;
8. 1080p: the importer's test scene with 12 spheres, 6 boxes, 10 octaves
   and 10 warp octaves (``tscn_fixture``, written to a temporary
   directory) through ``cli.main(["render", "--scene", ...,
   "--stats", "8"])``, procedural (``megakernel_gen``) and ``--textures``
   (the general texture instance): counters (the plan's K1 launches on
   each of the 9 frames, no plain call), ``FrameStats``, the frame held
   against ``renderer="plain"`` at the cloud tolerance, or, where one ulp
   of the camera moves the plain frame beyond it (measured first), at the
   strictest tolerance that move keeps (``ulp_tolerance_ok``: p99 for
   p99.9, else twice the move per statistic); the procedural scene's
   frame with two octaves fewer through the same comparison (logged: with
   the imported octave chains it lies within one ulp's move), and the same
   scene with GEOMETRY_CHAINS, held the same way, whose two-octaves-fewer
   frame must fail the comparison; then kernel ms,
   device ms, the bound (the extra spheres, boxes and octaves charged),
   ``Scene.render`` ms, idle share and plain ms; large worlds through K1:
   the Earth-scale scene at the origin and translated by (3e7, 1e7, −2e7)
   (max |Δ| ≤ 1e-5) and the raw-f32 control at (2.56e8, 1e8, −1.6e8) (more
   than 10× the rebased error), the flagship and an 8-frame TAA flight
   translated by (3e7, 1e7, −2e7) against the untranslated ones (≤ 1e-5,
   each frame against plain at the cloud tolerance); and the CLI's other
   commands on the card: the flagship with the glow (no ``--device``),
   ``fly --taa --frames 8 --size 1152`` (K3 8 times), ``bake-lut`` and
   ``export-cubemap``, each writing its file.

Inverse rendering (``models/inverse.py``, ``train_step_sharded``), which
differentiates the plain frame (autograd; the kernels have no backward, as
the Pallas ones have none), runs last:

9. 9a: the CLI's ``fit`` at the JAX defaults (``no_clouds``/exterior,
   128², 60 steps, lr 0.05, no ``--device``): one plain frame a step plus
   the target's, no K1 launch, the last loss below 0.2 × the first and the
   density moved toward the true 0.5; ms a step, peak memory and the idle
   share of a ``torch.profiler`` trace of 3 steps.  9b: one step's loss and
   gradients on ``clouds_high``/avatar at 256×384 over the seven knobs, on
   the card and on the CPU from the same inputs: the loss at rtol 1e-5 and
   each gradient element within 1e-3 of its CPU |g| plus 1e-4 of the
   largest CPU |g|; all finite.  9c: 10 steps of the
   fit on that problem, then the start and the fitted parameters through
   K1 (no plain call): the fitted kernel frame against the plain one at
   the cloud tolerance, and its loss below the start's.  9d: the sharded
   step on 2 shards of the local mesh and on NCCL at world size 1 against
   the unsharded step (rtol 1e-5; world size 1 bit for bit).  9e: one
   step at 1080×1920 where 9b's peak memory, scaled by pixels, stays under
   60 GB: ms, peak memory, idle share.

Prints a JSON line describing each kernel (with its roofline bound from
this run's work counters), then, as the last line,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line.  Run from the repository root: ``python3 chip_smoke.py``
(``--quick`` stops after phase 3k).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from godot_atmosphere_shader_tpu_torch.tools.gpu_checks import (  # the gate's statistics
    ALLON_SIG_PATH, MOON, SIG_MAX_TOL, SIG_MEAN_TOL, SIG_PATH, allon_panorama, block_signature,
    cloud_deltas, cloud_tolerance_ok, detail_tolerance_ok, frame_array, ulp_tolerance_name,
    ulp_tolerance_ok)

ROOT = os.path.dirname(os.path.abspath(__file__))
TILE = 32  # rows of the kernel's tile
CHECK_SIZE = (256, 384)
FULL_SIZE = (1080, 1920)
CHECK_CASES = (("no_clouds", "avatar"), ("clouds", "avatar"),
               ("clouds_high", "avatar"), ("clouds_high", "interior"))
TEXTURE_POSES = ("avatar", "interior")
K2_ATOL = 2e-6
BAND_FIELD_BATCHES = 16  # the JAX band-fidelity tool's default --max-batches
BAKE_ATOL = 1e-5
KERNEL_FRAMES = 10
PLAIN_FRAMES = 2

# One H100 SXM (NVIDIA data sheet): fp32 outside the tensor cores, HBM rate;
# the INT32 rate derived from the SM's 64 INT32 lanes (half its 128 FP32
# lanes) at the data sheet's 1.98 GHz, in instructions per second.  Every
# bound divides by the card's ceilings as phase 7b reads them (PEAK, set
# before the first bound): for each of fp32 and INT32 the larger of T2's
# measured rate and SMs × lanes × the SM clock it sampled under load (128
# FP32 lanes doing 2 operations per FMA, 64 INT32 lanes), so that no bound
# divides by less than the card can do; the spec values are printed beside
# them.
SPEC_FP32 = 67e12
SPEC_INT32 = 132 * 64 * 1.98e9
PEAK = {"fp32": SPEC_FP32, "int32": SPEC_INT32}
PEAK_BYTES = 3.35e12
# Arithmetic operations per unit of work, counted by hand from
# csrc/megakernel.cu (one per add, multiply, compare, select, conversion or
# special function; a fused multiply-add counts 2; loads count 0), fp32
# apart from int32 (one per integer instruction).  The kernel's work
# counters say how many units this run's inputs needed.
# a pixel's ray, opaque pass, shell and ground hits (200) and its blend:
# the clouds over the atmosphere and the composite over the background
# (blend_and_store, 60)
OPS_SHADE_PIXEL = 200
OPS_BLEND_PIXEL = 60
OPS_PIXEL = OPS_SHADE_PIXEL + OPS_BLEND_PIXEL
# One v2 integration (atmosphere_v2): per pixel the step length and start
# (9) and the output mix (16); per step (config.atmosphere_steps of them)
# the sun depth's chord (optical_depth_analytic: position, radius clamp,
# b, c0 and q2, 31; the shell's and the ground's roots, their clamps,
# the segment tests and the sum, 27) and the view sample (distance 9,
# density 9, the three channels' extinction and in-scatter 22, alpha 4,
# advance 6), 110; and per quadrature segment evaluated (od_segment; the
# work slot od_segments counts them, two per step unless one is empty) 8
# nodes of 15 (node 2, offset 1, radius 3, height 4, cube 2, weight 2,
# step 1) and its scale 3, 123
OPS_V2_PIXEL = 25
OPS_V2_STEP = 110
OPS_OD_SEGMENT = 123
OPS_STEP = 115             # one march step with interpolated or given fields
# One evaluation of each noise basis, (fp32, int32): corner hashes
# (mix_fast 6 integer ops, mix 8), gradients from 10-bit hash fields,
# fades and lerps; cellular: 27 cells of a hash, a feature point (two more
# mixes) and a distance; cellular_fast: 8 cells.
BASIS_OPS = {"value": (58, 71), "simplex_smooth": (475, 245), "perlin": (164, 119),
             "simplex": (147, 103), "cellular": (663, 949), "cellular_fast": (192, 282)}
# per octave of each fractal (the octave's amplitude, the lacunarity), and
# what weighted_strength adds; one warp octave (a value-noise vec3 and the
# offset); a field (scale, frequency, 0.5 + 0.5 n); the coverage field's
# rotation and normalisation; the detail field's position
FRACTAL_OPS = {"none": 0, "fbm": 5, "ridged": 8, "ping_pong": 15}
WEIGHTED_OPS = 5
WARP_OPS = (165, 119)
FIELD_OPS = 8
COVERAGE_POINT_OPS = 22
DETAIL_POINT_OPS = 6
OPS_TEX3D = 110            # trilinear sample, position and footprint pass
OPS_TEX3D_FLOOR = 57       # nearest floor-level sample
OPS_LATLONG = 205          # polynomial (u, v) twice and a bilinear sample
OPS_LATLONG_FLOOR = 190
OPS_K2_LATLONG = OPS_LATLONG - 62  # K2 alone computes a sample's (u, v) once
# one sun-march sample of raymarched lighting (sun_march): position 7,
# length 6, height ratio 3, density 23, exp 5, alpha and step 6; plus the
# procedural fields where they are evaluated
OPS_SUN_SAMPLE = 50
# one v1 integration (atmosphere_v1): per step (config.atmosphere_steps of
# them) ~42 (distance 10, direction 4, cubic density 8, sun term 10, light
# sum and factor 5, advance 6), and the step length and the four-color mix
# ~28 per pixel
OPS_V1_STEP = 42
OPS_V1_PIXEL = 28
# one opaque-only pixel: ray 25, three spheres 3 × 22, the box slab test 55,
# shading or the star hash 50
OPS_OPAQUE_PIXEL = 200
# a scene's spheres and boxes beyond the demo's DEMO_SPHERES and DEMO_BOXES,
# which OPS_OPAQUE_PIXEL and OPS_SHADE_PIXEL count, per pixel of the opaque
# pass (geometry_ops): a ray/sphere test 22, a box's slab test 55, and for a
# box from the scene buffer its camera position in box space, 18
OPS_SPHERE, OPS_BOX, OPS_BOX_ORIGIN = 22, 55, 18
DEMO_SPHERES, DEMO_BOXES = 3, 1
# the panorama sky: every ray of a tile takes part in its choice once
# (polynomial atan2 and asin, the (u, v) map, min and max: 66; in the
# pre-pass also its ray, 25); a sky pixel computes its (u, v) again (62)
# and three bilinear channels sharing their indices and weights (60; floor
# mode: three nearest taps, 20).  Bytes: each pyramid level that a tile
# chose, read once from HBM in its three channels; the taps' 12 gathered
# floats per pixel come from L2 and add no HBM bytes.
OPS_SKY_UV = 66
OPS_SKY_CHOICE_RAY = 25 + OPS_SKY_UV
OPS_SKY_SAMPLE = 62 + 60
OPS_SKY_FLOOR = 62 + 20
# the general texture instance's tile pass (tex_choice_kernel), beyond the
# pixels' shading: each coarse pixel's coarse inputs (its mean ray,
# cloud-shell hits, visibility and model-space ray, and its share of the
# group's means: 75) and, for each baked knot of a coverage group that the
# frame samples no knot of, its sampler coordinates for its batch's choice
# (its position 10, min and max 6, and by field: coverage's rotation,
# normalisation and polynomial (u, v) 75, shape's scale and wrap 9,
# detail's 12).  A sampled knot's coordinates and its share of the choice
# are its sample's (OPS_TEX3D's position and footprint pass, OPS_LATLONG's
# second (u, v)), so they are charged once.
OPS_CHOICE_COARSE = 75
OPS_CHOICE_COORD = (91, 25, 28)
# frame-plane bytes per pixel: a fused layer writes color and alpha (16); a
# chained layer reads color, alpha and depth and writes color and alpha
# (36); the opaque-only pass writes color, alpha and depth (20)
BYTES_LAYER_PIXEL = 16
BYTES_CHAINED_PIXEL = 36
BYTES_OPAQUE_PIXEL = 20
# The TAA resolve per pixel (csrc/taa.cu, counted the same way): ray and
# reprojection ~75, window and bilinear of 4 planes ~70, 3×3 clamp of 3
# channels ~145, blend ~12.  Bytes per pixel: current rgb and depth read,
# history rgb and depth read once, rgb and depth written.
OPS_TAA_PIXEL = 300
BYTES_TAA_PIXEL = 48
TAA_MAX_ERR = 1e-4       # max |Δ| where kernel and plain agree on validity
TAA_MAX_FLIPS = 1e-4     # share of pixels whose validity may differ
FLIGHT_FRAMES = 8
FLIGHT_BLEND = 0.15
FLIGHT_REPS = 2
FLIGHT_TRACE_TRIES = 3  # traces of a flight until one holds all its kernels
SMALL_FLIGHT_FRAMES = 4
FILL_LAUNCHES = 32
FILL_ROUNDS = 9    # fill_kernel and fill_ timed in turns; the medians compared
FILL_REPLAYS = 20  # replays of the K = FILL_LAUNCHES fills captured in a CUDA graph
# JAX bench cells (bench.py:75-94): (cell, scene, pose, height, width)
BENCH_CELLS = (("1", "v1_no_clouds", "exterior", 256, 256),
               ("2", "no_clouds", "exterior", 512, 512),
               ("5", "cell5", "space", 1080, 1920),
               ("7", "gas_giant", "limb", 1080, 1920))
# phase 3d's scenes at 256x384: (scene, pose)
SCENE_CASES = (("v1_no_clouds", "exterior"), ("no_clouds", "exterior"), ("clouds", "space"),
               ("cell5", "space"), ("golden_chain", "space"))
SCENE_PLAIN_FRAMES = 1
# the panorama sky: the synthetic panorama's size, phase 3e's fused scenes
# (scene, pose, texture mode?) and phase 4d's 1080p frames (label, scene,
# pose, texture mode?)
PANO_SIZE = (1024, 2048)
SKY_SCENES = (("no_clouds", "avatar", False), ("clouds_high", "avatar", False),
              ("clouds_high", "avatar", True))
SKY_FRAMES = (("everything-on/avatar", "allon", "avatar", True),
              ("everything-on/space", "allon", "space", True),
              ("clouds_high/avatar", "clouds_high", "avatar", False),
              ("clouds_high/sunward", "clouds_high", "sunward", False))
GLOW_ATOL = 1e-5
# row shards: a fused layer over a shard writes color, alpha and depth (20 B
# per pixel); the sharded frame and flight at 1024 rows (the tallest frame
# under 1080 whose rows per shard are a multiple of the resolve's 32-row
# tile for 4 shards), the flagship at 1080p on 2 shards of 540 rows; K3's
# band mode alone with a 32-row halo
BYTES_BAND_PIXEL = 20
# K1 slice (h), the procedural envelope: the four 1080p frames of phase 4f,
# each held against the whole plain frame
ENVELOPE_FRAMES = ("cellular_tier", "reference_profile", "tscn_profile", "full_quality")
# the peak probe (T2): blocks per SM of 256 threads (4 waves at 8 resident
# blocks), loop iterations per launch (tens of ms each; 65,536 fma, 4,096
# expf, 8,192 __expf and 32,768 IMAD steps per chain), iterations of the
# small check against the plain chains and each op's tolerance, there and
# on every timed launch: fmaf against a multiply then an add (the chains
# contract towards their fixed point, so the gap stays a few ulps per
# chain, ~2e-6 over 16), the accurate expf against torch.exp, __expf's
# few-ulp error, uint32 exact
PEAK_BLOCKS_PER_SM = 32
PEAK_ITERS = {"fma": 1024, "exp": 512, "fast_exp": 1024, "imad": 512}
PEAK_CHECK_ITERS = 16
PEAK_TOL = {"fma": 1e-5, "exp": 1e-5, "fast_exp": 1e-4, "imad": 0.0}
PEAK_REPS = 3
# procedural shape knots over coverage groups of 32 rows: cloud_lod 1 with
# coverage_lod 32, and 2 with 16 (ill-conditioned: knot_group_tolerance_ok)
KNOT_GROUP_CASES = {
    "coverage_lod_32_shape_knots_16": dict(cloud_lod=1, cloud_coverage_lod=32, cloud_lod_interior=0,
                                           cloud_shape_interp=True, cloud_shape_knots=16),
    "coverage_lod_16_shape_knots_100": dict(cloud_lod=2, cloud_coverage_lod=16,
                                            cloud_lod_interior=0, cloud_shape_interp=True,
                                            cloud_shape_knots=100)}
# one flipped knot moves a 32-row group's column: 0.39 % of a 64x128 frame
KNOT_GROUP_SHARE = 5e-3
# phase 3i, the gas giant's limb band (tests/test_torch_goldens.py's frame):
# its size, the JAX XLA frame of the same scene (written once on a CPU by the
# JAX package, carried as a file), and the golden's budget: pixels off at
# atol 1e-5 / rtol 1e-4 at most GAS_GIANT_SHARE of the frame, all on rays
# through the shell, none by more than GAS_GIANT_MAX; the kernel's largest
# |Δ| is held to GAS_GIANT_ULP_MARGIN times the most that one ulp of the
# camera's position (the ulp of its largest coordinate, along each axis,
# each way: ULP_MOVES) moves the plain frames, on the card and on the CPU,
# where that is more than GAS_GIANT_MAX: two frames rounded apart, each
# within one such move of the exact frame
GAS_GIANT_SIZE = (192, 128)
GAS_GIANT_REF = os.path.join(ROOT, "tests", "golden_gas_giant_xla.npz")
GAS_GIANT_SHARE = 3e-3
GAS_GIANT_MAX = 5e-4
GAS_GIANT_ULP_MARGIN = 2.0
ULP_MOVES = tuple((axis, sign) for axis in range(3) for sign in (1, -1))
# phase 9, inverse rendering: the CLI's fit at its defaults (FIT_CLI_STEPS
# steps at FIT_CLI_SIZE²; its step timed over FIT_TIMED_STEPS and traced over
# FIT_TRACE_STEPS), the fit of clouds_high/avatar at CHECK_SIZE through K1
# (FIT_K1_STEPS), the sharded step on FIT_SHARDS shards, and the 1080p step
# where the estimate of its memory stays under FIT_MEMORY_LIMIT.  A
# clouds_high step is ~120,000 kernels: it is timed over FIT_BIG_TIMED_STEPS
# and traced once (a trace of one takes tens of seconds to read)
FIT_CLI_STEPS, FIT_CLI_SIZE = 60, 128
FIT_K1_STEPS = 10
FIT_TIMED_STEPS = 5
FIT_TRACE_STEPS = 3
FIT_BIG_TIMED_STEPS = 2
FIT_SHARDS = 2
FIT_MEMORY_LIMIT = 60e9
# K1 slice (i), the texture envelope: the texture clouds_high scene (both
# fields baked, the demo's profile) changed as each case says; phase 3h's
# cases at TEX_ENVELOPE_SIZE, phase 4g's frames at 1080p
TEX_ENVELOPE_SIZE = (64, 128)
TEX_ENVELOPE_CASES = {
    "shape baked, coverage knots": dict(coverage="procedural"),
    "shape baked, coverage per step": dict(coverage="procedural", cloud_coverage_interp=False),
    "shape knots, coverage baked": dict(shape="procedural", cloud_shape_interp=True),
    "shape per step, coverage baked": dict(shape="procedural"),
    "full quality": dict(clouds_always_low_quality=False),
    "full quality, raymarched light": dict(clouds_always_low_quality=False,
                                           raymarched_lighting=True),
    "coverage K = 4": dict(cloud_coverage_knots=4),
    "coverage K = 16": dict(cloud_coverage_knots=16),
    "shape knots 8": dict(cloud_shape_knots=8),
    "shape knots 32": dict(cloud_shape_knots=32),
    "G = 1": dict(cloud_lod=1, cloud_coverage_lod=1, cloud_lod_interior=0),
    "G = 2": dict(cloud_lod=1, cloud_coverage_lod=2, cloud_lod_interior=0),
    "G = 16": dict(cloud_lod=8, cloud_coverage_lod=2, cloud_lod_interior=0),
    "G = 32": dict(cloud_lod=16, cloud_coverage_lod=2, cloud_lod_interior=0),
    "knot group 1": dict(texture_knot_group=1),
    "knot group 17": dict(texture_knot_group=17),
    "knot group 17, G = 2": dict(texture_knot_group=17, cloud_lod=1, cloud_lod_interior=0),
    "9-level shape pyramid": dict(levels=9),
    "9-level shape pyramid, G = 1": dict(levels=9, cloud_lod=1, cloud_coverage_lod=1,
                                         cloud_lod_interior=0),
}
TEX_REF_FRAME = "texture reference profile"
TEX_ENVELOPE_FRAMES = {
    TEX_REF_FRAME: dict(cloud_lod=1, cloud_coverage_lod=1, cloud_lod_interior=0),
    "texture full quality": dict(clouds_always_low_quality=False),
    "shape baked, coverage procedural": dict(coverage="procedural"),
    "shape procedural, coverage baked": dict(shape="procedural"),
}
ENVELOPE_KERNEL_FRAMES = 5
SMALL_SHARDS = 2
SHARD_SIZE = (1024, 1920)
SHARDS = 4
FLAGSHIP_SHARDS = 2
TAA_HALO = 32

# the .tscn import of phase 8: the importer's test scene (tests/test_tscn.py
# FIXTURE, a planet R = 50 with clouds, a ground sphere and a crate), with
# spheres and boxes added up to TSCN_SPHERES and TSCN_BOXES MeshInstance3D
# nodes and TSCN_OCTAVES octaves on the shape noise and on the coverage's
# domain warp (FastNoiseLite goes up to 10): beyond the launch struct's
# inline 8 spheres, 4 boxes and 8 octaves
TSCN_FIXTURE = """[gd_scene load_steps=8 format=3]

[ext_resource type="PackedScene" path="res://addons/zylann.atmosphere/planet_atmosphere.tscn" id="2"]
[ext_resource type="Shader" path="res://addons/zylann.atmosphere/shaders/planet_atmosphere_clouds.gdshader" id="3"]
[ext_resource type="Script" path="res://addons/zylann.atmosphere/noise_cubemap.gd" id="4"]

[sub_resource type="StandardMaterial3D" id="mat_ground"]
albedo_color = Color(0.2, 0.5, 0.3, 1)

[sub_resource type="SphereMesh" id="ground_mesh"]
material = SubResource("mat_ground")
radius = 50.0
height = 100.0

[sub_resource type="FastNoiseLite" id="shape_noise"]
noise_type = 2
frequency = 0.15
fractal_type = 2
fractal_octaves = 6
fractal_gain = 0.7

[sub_resource type="NoiseTexture3D" id="shape_tex"]
seamless = true
noise = SubResource("shape_noise")

[sub_resource type="FastNoiseLite" id="cov_noise"]
domain_warp_enabled = true
domain_warp_amplitude = 45.0
domain_warp_frequency = 0.02
domain_warp_fractal_octaves = 2

[sub_resource type="Cubemap" id="cov_cube"]
script = ExtResource("4")
noise = SubResource("cov_noise")
resolution = 128
scale = Vector3(50, 80, 50)

[sub_resource type="BoxMesh" id="box_mesh"]
size = Vector3(4, 6, 8)

[node name="Root" type="Node"]

[node name="Sun" type="MeshInstance3D" parent="."]
transform = Transform3D(1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 300)

[node name="Light" type="DirectionalLight3D" parent="Sun"]
transform = Transform3D(1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, -60)

[node name="Ground" type="MeshInstance3D" parent="."]
material_override = SubResource("mat_ground")
mesh = SubResource("ground_mesh")

[node name="Atmo" parent="." instance=ExtResource("2")]
planet_radius = 50.0
atmosphere_height = 4.0
sun_path = NodePath("../Sun/Light")
custom_shader = ExtResource("3")
shader_params/u_density = 0.7
shader_params/u_scattering_strength = 1.5
shader_params/u_atmosphere_modulate = Color(1, 0.9, 0.8, 1)
shader_params/u_cloud_top = 0.55
shader_params/u_cloud_shape_texture = SubResource("shape_tex")
shader_params/u_cloud_coverage_cubemap = SubResource("cov_cube")

[node name="Crate" type="MeshInstance3D" parent="."]
transform = Transform3D(1, 0, 0, 0, 1, 0, 0, 0, 1, 30, 0, 40)
mesh = SubResource("box_mesh")
"""
TSCN_SPHERES, TSCN_BOXES, TSCN_OCTAVES = 12, 6, 10
TSCN_POSE = "avatar"
# phase 8's fly --taa: square, the side nearest 1080 that the resolve's
# 128-column tiling takes (the CLI refuses others, as JAX's does)
FLY_SIZE = 1152


def tscn_fixture(spheres: int = TSCN_SPHERES, boxes: int = TSCN_BOXES,
                 octaves: int = TSCN_OCTAVES) -> str:
    """The importer's test scene with ``spheres`` sphere and ``boxes`` box
    MeshInstance3D nodes in all (moons on a ring about the planet, crates
    turned about y) and ``octaves`` fractal octaves on the shape noise and
    warp octaves on the coverage noise."""
    text = TSCN_FIXTURE.replace("fractal_octaves = 6", f"fractal_octaves = {octaves}")
    text = text.replace("domain_warp_fractal_octaves = 2",
                        f"domain_warp_fractal_octaves = {octaves}")
    res, nodes = [], []
    for i in range(spheres - 1):  # the ground is the first
        a = 2.0 * np.pi * i / max(spheres - 1, 1)
        res.append(f'[sub_resource type="StandardMaterial3D" id="moon_mat{i}"]\n'
                   f'albedo_color = Color({0.3 + 0.05 * i:.2f}, 0.4, {0.9 - 0.05 * i:.2f}, 1)\n\n'
                   f'[sub_resource type="SphereMesh" id="moon_mesh{i}"]\n'
                   f'material = SubResource("moon_mat{i}")\nradius = {2.0 + 0.5 * i}\n\n')
        nodes.append(f'\n[node name="Moon{i}" type="MeshInstance3D" parent="."]\n'
                     f'transform = Transform3D(1, 0, 0, 0, 1, 0, 0, 0, 1, '
                     f'{75.0 * np.cos(a):.3f}, {12.0 * np.sin(2 * a):.3f}, '
                     f'{75.0 * np.sin(a):.3f})\nmesh = SubResource("moon_mesh{i}")\n')
    for i in range(boxes - 1):  # the crate is the first
        a = 0.4 + 0.7 * i
        c, s_ = np.cos(a), np.sin(a)
        nodes.append(f'\n[node name="Crate{i}" type="MeshInstance3D" parent="."]\n'
                     f'transform = Transform3D({c:.6f}, 0, {-s_:.6f}, 0, 1, 0, {s_:.6f}, 0, '
                     f'{c:.6f}, {-40.0 + 20.0 * i:.1f}, {-10.0 + 6.0 * i:.1f}, 60)\n'
                     f'mesh = SubResource("box_mesh")\n')
    at = text.index("[node ")
    return text[:at] + "".join(res) + text[at:] + "".join(nodes)

# phase 3j: the launch struct's inline entries and past them, at
# GEOMETRY_SIZE: (spheres, boxes, octaves and warp octaves) per case, each
# through every instance that takes it (GEOMETRY_INSTANCES)
GEOMETRY_SIZE = (64, 128)
GEOMETRY_CASES = ((1, 4, 8), (8, 4, 8), (9, 5, 9), (16, 12, 10), (33, 5, 10))
GEOMETRY_INSTANCES = ("procedural", "cloud-free", "texture", "texture general")
# the octave chains of those cases' procedural fields: with the demo's
# (lacunarity 2, warp lacunarity 6, gains 0.665 and 0.5) the 8th warp
# octave samples at ~6e5 lattice units, where one ulp of the camera moves
# the plain 64x128 frame by mean 4e-3 (9.5 % of pixels above 1e-2): as far
# as kernel and plain lie apart, so the comparison could tell nothing.
# These keep every octave's lattice coordinates small and its amplitude
# large, so the octaves the scene buffer holds weigh in the frame
# (geometry_conditioning measures both)
GEOMETRY_CHAINS = dict(lacunarity=1.2, gain=0.8, warp_lacunarity=1.2, warp_gain=0.8)
# the Earth-scale scene of tests/test_large_world.py (phase 8) and its
# offsets: translated, and the raw-f32 control's
EARTH_RADIUS, EARTH_HEIGHT = 6.371e6, 1.0e5
LARGE_OFFSET = (3.0e7, 1.0e7, -2.0e7)
RAW_OFFSET = (2.56e8, 1.0e8, -1.6e8)
LARGE_WORLD_MAX = 1e-5


def crowded_scene(instance: str, spheres: int, boxes: int, octaves: int, device,
                  textures=None, seed: int = 0, chains=GEOMETRY_CHAINS):
    """The demo scene at the avatar pose with ``spheres`` spheres and
    ``boxes`` boxes (the demo's first, then seeded ones in view: small
    spheres, turned boxes) and, in its procedural fields, ``octaves``
    octaves and warp octaves.  ``instance``: ``"procedural"``
    (``clouds_high``), ``"cloud-free"`` (``no_clouds``), ``"texture"``
    (both fields baked: the fixed texture instance) or ``"texture
    general"`` (the shape baked beside the procedural coverage); ``chains``:
    the fields' lacunarities and gains (``{}``: the demo's); updated."""
    from godot_atmosphere_shader_tpu_torch.models.demo import COVERAGE_NOISE, COVERAGE_SCALE
    from godot_atmosphere_shader_tpu_torch.models.params import ProceduralField
    from godot_atmosphere_shader_tpu_torch.render.opaque import OpaqueScene

    variant = "no_clouds" if instance == "cloud-free" else "clouds_high"
    baked = instance.startswith("texture")
    scene, cam = scene_and_camera(variant, "avatar", device,
                                  textures=textures if baked else None)
    atmo = scene.atmospheres[0]
    cfg = atmo.config
    if cfg.clouds_enabled:
        change = {}
        if instance == "texture general":
            change["cloud_coverage_noise"] = ProceduralField(COVERAGE_NOISE, COVERAGE_SCALE)
        for name in ("cloud_shape_noise", "cloud_coverage_noise"):
            field = change.get(name, getattr(cfg, name))
            if field is not None:
                change[name] = dataclasses.replace(field, noise=dataclasses.replace(
                    field.noise, octaves=octaves, warp_octaves=octaves, **chains))
        atmo.set_custom_shader(dataclasses.replace(cfg, **change))
    rng = np.random.default_rng(seed)
    o = scene.opaque
    sph = [(o.sphere_centers[i].tolist(), float(o.sphere_radii[i]), o.sphere_albedos[i].tolist(),
            float(o.sphere_unshaded[i])) for i in range(o.sphere_centers.shape[0])][:spheres]
    while len(sph) < spheres:
        c = rng.uniform((-110.0, -70.0, 60.0), (110.0, 70.0, 130.0))
        sph.append((c.tolist(), float(rng.uniform(1.5, 6.0)), rng.uniform(0.1, 0.9, 3).tolist(),
                    float(rng.random() < 0.2)))
    box = [(o.box_world_to_box[i].cpu().numpy(), o.box_half_sizes[i].tolist(),
            o.box_albedos[i].tolist()) for i in range(o.box_world_to_box.shape[0])][:boxes]
    while len(box) < boxes:
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        r = q * np.sign(np.linalg.det(q))
        t = rng.uniform((-100.0, -60.0, 40.0), (100.0, 60.0, 120.0))
        w2b = np.eye(4, dtype=np.float32)
        w2b[:3, :3], w2b[:3, 3] = r.T, -(r.T @ t)
        box.append((w2b, rng.uniform(1.0, 6.0, 3).tolist(), rng.uniform(0.2, 0.9, 3).tolist()))
    scene.opaque = OpaqueScene.create(
        spheres=sph, boxes=box, light_dir=o.light_dir.tolist(), ambient=float(o.ambient),
        sky_color=o.sky_color.tolist(), star_intensity=float(o.star_intensity), device=device)
    scene.update(0.5, cam)
    return scene, cam


def earth_scene(offset, device, large_world=None):
    """tests/test_large_world.py's scene (R = 6.371e6, the camera 60 km up
    looking at the limb) translated by ``offset``; float64 camera."""
    from godot_atmosphere_shader_tpu_torch.models.scene import Node3D, PlanetAtmosphere, Scene
    from godot_atmosphere_shader_tpu_torch.render.opaque import OpaqueScene
    from godot_atmosphere_shader_tpu_torch.utils.camera import Camera, look_at

    offset = np.asarray(offset, np.float64)
    sun = Node3D(position=offset + np.array([1.5e8, 0.0, 0.0]))
    atmo = PlanetAtmosphere(planet_radius=EARTH_RADIUS, atmosphere_height=EARTH_HEIGHT, sun=sun,
                            custom_shader="no_clouds", position=offset, density=0.005,
                            scattering_strength=1.0, device=device)
    opaque = OpaqueScene.create(spheres=[(offset, EARTH_RADIUS, (0.25, 0.22, 0.2))],
                                light_dir=(-1.0, 0.0, 0.0), sky_color=(0.0, 0.0, 0.0),
                                device=device)
    scene = Scene([atmo], opaque, large_world=large_world, device=device)
    eye = offset + np.array([0.0, EARTH_RADIUS + 6.0e4, 0.0])
    target = offset + np.array([2.0e6, EARTH_RADIUS - 1.0e5, 0.0])
    cam = Camera.create(look_at(eye, target), fov_y_deg=70.0, near=10.0, far=1.0e8,
                        device=device)
    scene.update(0.0, cam)
    return scene, cam


def translated_scene(scene, cam, offset, large_world=True):
    """The same scene with every node, the opaque geometry and the camera
    moved by ``offset`` in float64 (the camera's transform and the
    geometry's positions kept as float64 tensors), rendered with
    ``large_world``."""
    import copy

    from godot_atmosphere_shader_tpu_torch.utils.camera import Camera

    offset = np.asarray(offset, np.float64)
    moved = copy.copy(scene)
    moved.atmospheres = []
    for a in scene.atmospheres:
        b = copy.copy(a)
        b.transform = a.transform.copy()
        b.transform[:3, 3] += offset
        if a.sun is not None:
            b.sun = copy.copy(a.sun)
            b.sun.transform = a.sun.transform.copy()
            b.sun.transform[:3, 3] += offset
        moved.atmospheres.append(b)
    o = scene.opaque
    sc = o.sphere_centers.double().cpu().numpy() + offset
    bm = o.box_world_to_box.double().cpu().numpy()
    bm[:, :3, 3] -= bm[:, :3, :3] @ offset
    # float64 world positions: only their rebased, camera-relative copies
    # reach the device as float32 (large_world is on)
    moved.opaque = dataclasses.replace(
        o, sphere_centers=torch.as_tensor(sc, device=o.sphere_centers.device),
        box_world_to_box=torch.as_tensor(bm, device=o.sphere_centers.device))
    moved.large_world = large_world
    moved._rebased, moved._opaque_host_cache = None, {}
    moved._rebase_origin = None
    m = cam.view_to_world.double().cpu().numpy()
    m[:3, 3] += offset
    return moved, dataclasses.replace(cam, view_to_world=torch.as_tensor(
        m, dtype=torch.float64, device=cam.view_to_world.device))


def log(*args):
    print(*args, flush=True)


def clock(phase: str, start: float):
    """Where the run stands: the seconds since ``start`` as ``phase`` begins."""
    log(f"[clock] phase {phase} at {time.time() - start:.1f} s")


def knot_group_tolerance_ok(st: dict) -> bool:
    """Procedural shape knots over a coverage group of 32 rows
    (:data:`KNOT_GROUP_CASES`): the group's knots lie along its mean march
    span, and one ulp of one pixel's span moves a knot's shape value enough
    to change the group's whole column of 32 pixels (phase 3g measures it:
    the plain frame against itself with every span one ulp longer).  p99
    takes the place of p99.9 and KNOT_GROUP_SHARE that of the share of
    pixels above 1e-2; the mean is the cloud tolerance's."""
    return (st["p99"] <= 1e-3 and st["mean"] <= 1e-4
            and st["frac_above_1e-2"] <= KNOT_GROUP_SHARE)


def check_frame(img: np.ndarray, what: str):
    if not np.isfinite(img).all():
        raise RuntimeError(f"{what}: non-finite values")
    a = img[..., 3]
    if a.min() < 0.0 or a.max() > 1.0:
        raise RuntimeError(f"{what}: alpha outside [0, 1] ({a.min()}, {a.max()})")
    if float(img[..., :3].max()) <= 0.0:
        raise RuntimeError(f"{what}: blank frame")


def check_signature(img: np.ndarray, path: str, label: str):
    """An (H, W, 3) frame against a committed block signature (block mean
    ≤ 3e-3, block max ≤ 3e-2); logs the worst blocks."""
    mean_sig, max_sig = block_signature(img)
    ref = np.load(path)
    dmean = np.abs(mean_sig.astype(np.float32) - ref["mean"].astype(np.float32))
    dmax = np.abs(max_sig.astype(np.float32) - ref["max"].astype(np.float32))
    log(f"[signature] {label}: block mean delta max {dmean.max():.6g} (tol {SIG_MEAN_TOL}), "
        f"block max delta max {dmax.max():.6g} (tol {SIG_MAX_TOL}), "
        f"blocks over: mean {int((dmean > SIG_MEAN_TOL).sum())}, "
        f"max {int((dmax > SIG_MAX_TOL).sum())}")
    for name, d in (("mean", dmean), ("max", dmax)):
        worst = np.argsort(d.reshape(-1))[::-1][:5]
        for f in worst:
            by, bx, c = np.unravel_index(f, d.shape)
            log(f"[signature]   worst block-{name}: rows {by * 8}-{by * 8 + 7} "
                f"cols {bx * 128}-{bx * 128 + 127} ch {c}: {d[by, bx, c]:.6g}")
    if dmean.max() > SIG_MEAN_TOL or dmax.max() > SIG_MAX_TOL:
        raise RuntimeError(f"{label} disagrees with the committed signature")
    return float(dmean.max()), float(dmax.max())


def synthetic_panorama(height: int, width: int, seed: int = 0) -> np.ndarray:
    """A seeded (H, W, 3) linear space panorama: a dim nebula (a coarse
    random grid upsampled bilinearly) and a few thousand stars, some of
    them HDR."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((3, 17, 33)).astype(np.float32)
    ys = np.linspace(0.0, 16.0, height)
    xs = np.linspace(0.0, 32.0, width)
    y0 = np.minimum(ys.astype(np.int64), 15)
    x0 = np.minimum(xs.astype(np.int64), 31)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    top = coarse[:, y0][:, :, x0] * (1 - fx) + coarse[:, y0][:, :, x0 + 1] * fx
    bot = coarse[:, y0 + 1][:, :, x0] * (1 - fx) + coarse[:, y0 + 1][:, :, x0 + 1] * fx
    img = (0.005 + 0.06 * (top * (1 - fy) + bot * fy) ** 2).transpose(1, 2, 0)
    n = height * width // 500
    img[rng.integers(0, height, n), rng.integers(0, width, n)] = rng.uniform(0.2, 2.0, (n, 1))
    return np.ascontiguousarray(img, np.float32)


def with_panorama(scene, pano: np.ndarray):
    """The scene with ``pano`` as its opaque scene's panorama sky."""
    scene.opaque = dataclasses.replace(scene.opaque,
                                       panorama=torch.as_tensor(pano, device=scene.device))
    return scene


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def scene_and_camera(variant, pose, device, t=0.5, textures=None):
    """The demo scene; ``textures`` (shape, cubemap) selects texture mode."""
    from godot_atmosphere_shader_tpu_torch.models.demo import (build_demo_scene,
                                                               demo_camera)

    scene = build_demo_scene(variant, procedural=textures is None, device=device,
                             textures=textures)
    cam = demo_camera(pose, device=device)
    scene.update(t, cam)
    return scene, cam


def frame_inputs(scene, cam):
    """What Scene.render hands the kernel wrapper for this frame: params,
    config (texture mode: with its pyramid metas), camera, opaque scene and
    the pyramid tables (None for procedural fields)."""
    _, params, configs = scene._sorted_layers(cam)
    config, tex = scene._texture_plan(params[0], configs[0])
    return (params[0], config, cam, scene.opaque), tex


def time_cuda(fn, frames: int, warmup: int = 2) -> float:
    """Milliseconds per call over ``frames`` calls, by CUDA events."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(frames):
        fn(warmup + i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / frames


def device_busy_ms(fn, frames: int, first: int) -> tuple:
    """``(busy, megakernel)`` device milliseconds per call in a
    ``torch.profiler`` trace of ``frames`` calls: the union of all device
    intervals (kernels and copies), and the megakernel's own time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(frames):
            fn(first + i)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernel = sum(e.time_range.elapsed_us() for e in events if "megakernel" in e.name)
    return busy_us(events) / 1e3 / frames, kernel / 1e3 / frames


def busy_us(events) -> float:
    """Microseconds covered by the union of the events' device intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def noise_ops(field, coverage: bool = False) -> tuple:
    """(fp32, int32) operations of one evaluation of a procedural field
    (``ProceduralField``): its warp, each octave's basis and fractal step,
    the field's own arithmetic (and the coverage field's rotation)."""
    spec = field.noise
    fp, it = BASIS_OPS[spec.noise_type]
    octaves = 1 if spec.fractal_type == "none" else spec.octaves
    per = FRACTAL_OPS[spec.fractal_type] + (WEIGHTED_OPS if spec.weighted_strength else 0)
    warp = spec.warp_octaves if spec.warp_enabled else 0
    return (octaves * (fp + per) + warp * WARP_OPS[0] + FIELD_OPS
            + (COVERAGE_POINT_OPS if coverage else 0),
            octaves * it + warp * WARP_OPS[1])


def ops_time_ms(fp_ops: float, int_ops: float = 0.0) -> float:
    """The least time of these operations on this card: fp32 operations
    over the measured fp32 peak, int32 instructions over the measured INT32
    rate, where both share the warp schedulers' one dispatch per clock and
    INT32 has half the lanes: max(t_fp + t_int / 2, t_int)."""
    t_fp = fp_ops / PEAK["fp32"] * 1e3
    t_int = int_ops / PEAK["int32"] * 1e3
    return max(t_fp + t_int / 2.0, t_int)


def atmosphere_ops(work: dict, config) -> int:
    """The operations of a launch's atmosphere integrations: v2 and v1 per
    pixel and per step of the layer's ``config.atmosphere_steps``, and v2's
    sun-depth quadrature segments as the kernel counted them
    (``od_segments``)."""
    n = config.atmosphere_steps
    if not work["od_segments"] <= 2 * n * work["atmosphere"]:
        raise RuntimeError(f"{work['od_segments']} quadrature segments counted for "
                           f"{work['atmosphere']} v2 integrations of {n} steps")
    return (work["atmosphere"] * (OPS_V2_PIXEL + n * OPS_V2_STEP)
            + work["od_segments"] * OPS_OD_SEGMENT
            + work["v1_atmosphere"] * (OPS_V1_PIXEL + n * OPS_V1_STEP))


def work_ops(work: dict, config) -> dict:
    """A launch's operations from its work counts, by what runs them:
    ``shade`` (each pixel's ray, opaque pass and hits, its atmosphere, the
    opaque-only pixels, the sky's samples), ``blend`` (each pixel's clouds
    and composite), ``clouds`` (the march, the sun samples, the baked
    fields' samples, the procedural fields' noise) and ``int_ops`` (the
    noise's int32 instructions).  A procedural layer's noise comes from the
    work counters: the procedural instance counts each field's evaluations
    and knots."""
    steps = config.cloud_steps
    shade = (work["pixels"] * OPS_SHADE_PIXEL + atmosphere_ops(work, config)
             + work["opaque_pixels"] * OPS_OPAQUE_PIXEL
             + work["sky"] * OPS_SKY_SAMPLE + work["sky_floor"] * OPS_SKY_FLOOR)
    clouds = (work["march"] * steps * OPS_STEP + work["sun_samples"] * OPS_SUN_SAMPLE
              + work["tex3d"] * OPS_TEX3D + work["tex3d_floor"] * OPS_TEX3D_FLOOR
              + work["latlong"] * OPS_LATLONG + work["latlong_floor"] * OPS_LATLONG_FLOOR)
    # each procedural field's noise by its own spec (a baked field's samples
    # are the tex3d and latlong slots above, the detail knots among them):
    # coverage knots (knot_groups groups of K + 1) and per-step evaluations,
    # shape and detail per step and at knots
    units = []
    if config.clouds_enabled and config.cloud_coverage_tex_meta is None:
        cov = noise_ops(config.cloud_coverage_noise, coverage=True)
        if config.cloud_coverage_interp:
            units.append((cov, work["knot_groups"] * (max(config.cloud_coverage_knots, 1) + 1)))
        units.append((cov, work["coverage_evals"]))
    if config.clouds_enabled and config.cloud_shape_tex_meta is None:
        shape = noise_ops(config.cloud_shape_noise)
        detail = (shape[0] + DETAIL_POINT_OPS, shape[1])
        units += [(shape, work["shape_evals"]), (detail, work["detail_evals"]),
                  (shape, work["shape_knots"]), (detail, work["detail_knots"])]
    clouds += sum(u[0] * n for u, n in units)
    return {"shade": shade, "blend": work["pixels"] * OPS_BLEND_PIXEL, "clouds": clouds,
            "int_ops": sum(u[1] * n for u, n in units)}


def geometry_ops(struct, work: dict) -> int:
    """The operations of a launch's opaque pass for the spheres and boxes
    beyond the demo's (none for fewer), per pixel that runs it; the
    buffer's boxes also compute the camera's position in box space."""
    if not struct.with_opaque or struct.with_background:
        return 0
    per = (OPS_SPHERE * max(struct.n_spheres + struct.ext_spheres - DEMO_SPHERES, 0)
           + OPS_BOX * max(struct.n_boxes + struct.ext_boxes - DEMO_BOXES, 0)
           + OPS_BOX_ORIGIN * struct.ext_boxes)
    return (work["pixels"] + work["opaque_pixels"]) * per


def _bound(ops: int, int_ops: int, nbytes: int) -> dict:
    t_ops, t_bytes = ops_time_ms(ops, int_ops), nbytes / PEAK_BYTES * 1e3
    return {"ops": ops, "int_ops": int_ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def roofline(work: dict, config, height: int, width: int, table_bytes: int = 0,
             frame_bytes=None, sky_bytes: int = 0, sky_choice_ops: int = 0,
             extra_ops: int = 0) -> dict:
    """The least time the card could take for this launch's work: the
    larger of its operations' time (:func:`ops_time_ms`, fp32 and int32
    apart; :func:`work_ops`) and its bytes (frame planes read and written
    once, ``frame_bytes``, by default the outputs of a fullscreen layer;
    blue noise and pyramids read once; ``sky_bytes``: the sky levels its
    tiles chose) over the HBM rate.  ``sky_choice_ops``: the operations of
    the sky's per-tile choice (:func:`sky_cost`); ``extra_ops``: more fp32
    operations (:func:`geometry_ops`)."""
    ops = work_ops(work, config)
    if frame_bytes is None:
        frame_bytes = height * width * BYTES_LAYER_PIXEL
    return _bound(ops["shade"] + ops["blend"] + ops["clouds"] + sky_choice_ops + extra_ops,
                  ops["int_ops"],
                  frame_bytes + 256 * 256 * 4 + table_bytes + sky_bytes)


def tex_general_roofline(work: dict, config, struct, tparams, table_bytes: int,
                         frame_bytes: int, sky_bytes: int = 0, sky_choice_ops: int = 0,
                         depth_bytes: int = 0, extra_ops: int = 0) -> dict:
    """The general texture instance's bound, each of its two launches
    charged with what it runs (:func:`roofline`'s arguments; ``depth_bytes``:
    the depth plane's share of ``frame_bytes``, read by a chained layer or
    written on a shard; ``extra_ops``: the opaque pass's geometry beyond the
    demo's, :func:`geometry_ops`).  ``tile``, the tile pass: the pixels'
    shading and atmosphere and the sky (:func:`work_ops`'s ``shade``,
    ``sky_choice_ops``, ``extra_ops``),
    the coarse pixels of its padded tile grid and the knot coordinates of
    the coverage groups the frame does not sample (:data:`OPS_CHOICE_COARSE`);
    bytes: the blue noise, the sky's levels, the depth plane and the
    choices.  ``frame``: the blend and the clouds; bytes: the other frame
    planes and the pyramids.  ``bound_ms`` and ``bound_by``: the two
    launches' work together, as one launch's (the sum of theirs where both
    are bound by fp32 operations; less where the frame's int32 noise
    leaves room for the tile pass's fp32 work), so that the bound is the
    function's, whatever launches run it."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    ops = work_ops(work, config)
    tiles, slots, _ = mk.tex_choice_shape(struct, tparams)
    rays = tiles * TILE * 128
    groups = rays // (struct.cloud_lod * struct.coverage_lod)
    # the knots of one coverage group whose coordinates take part in a choice
    coords = 0
    if tparams.cov_source == mk.SOURCE_PYRAMID:
        coords += (struct.coverage_knots + 1) * OPS_CHOICE_COORD[0]
    if tparams.shape_source == mk.SOURCE_PYRAMID:
        coords += (struct.shape_knots + 1) * OPS_CHOICE_COORD[1]
        if not struct.always_low:
            coords += (struct.shape_knots + 1) * OPS_CHOICE_COORD[2]
    if not 0 <= work["knot_groups"] <= groups:
        raise RuntimeError(f"{work['knot_groups']} coverage groups sampled of {groups}")
    tile = _bound(ops["shade"] + sky_choice_ops + extra_ops
                  + rays // struct.cloud_lod * OPS_CHOICE_COARSE
                  + (groups - work["knot_groups"]) * coords, 0,
                  256 * 256 * 4 + sky_bytes + depth_bytes + tiles * slots * 8)
    frame = _bound(ops["blend"] + ops["clouds"], ops["int_ops"],
                   frame_bytes - depth_bytes + table_bytes)
    return dict(_bound(tile["ops"] + frame["ops"], frame["int_ops"],
                       tile["bytes"] + frame["bytes"]), tile=tile, frame=frame)


def sky_cost(cam, height: int, width: int, meta, in_block: bool, row0: int = 0,
             rows=None) -> dict:
    """What the sky adds to the bound of the launch that draws it (over
    rows ``[row0, row0 + rows)``, by default the frame): the bytes of the
    pyramid levels its tiles chose (three channels, each read once), and
    the operations of the choice: every ray of the padded tile grid once,
    with its ray in the pre-pass (the procedural instance and the
    opaque-only pass) or sharing it with the frame (``in_block``: the
    texture instance)."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    rows = height - row0 if rows is None else rows
    choices = mk.sky_choices_plain(cam, height, width, meta, row0=row0, rows=rows)
    levels = sorted(set(choices[:, 1].tolist()))
    ty, tx = mk.tile_grid(rows, width)
    rays = ty * tx * 32 * 128
    return {"sky_bytes": 3 * 4 * sum(meta.levels[l][0] * meta.levels[l][1] for l in levels),
            "sky_choice_ops": rays * (OPS_SKY_UV if in_block else OPS_SKY_CHOICE_RAY),
            "sky_levels": levels}


# -- K2 alone: the planes of tests/test_torch_texsample.py ----------------------

# (name, texture size, lo, extent, rows, sampler kwargs)
K2_TEX3D_CASES = (
    ("windowed_level0", 32, (0.47, 0.52, 0.31), (0.06, 0.06, 0.06), 16,
     dict(window_rows=48, band_rows=0)),
    ("minified", 64, (0.1, 0.1, 0.1), (0.35, 0.35, 0.35), 16,
     dict(window_rows=48, band_rows=0)),
    ("banded", 64, (20.2 / 64, 33.1 / 64, 11.4 / 64), (3.0 / 64, 3.0 / 64, 5.0 / 64), 16,
     dict(window_rows=16, band_rows=16)),
    ("slice_cap_declines", 64, (10.0 / 64, 10.0 / 64, 0.05), (2.0 / 64, 2.0 / 64, 0.4), 8,
     dict(window_rows=16, band_rows=16, band_max_slices=8)),
    ("floor_on_straddle", 32, (0.95, 0.4, 0.6), (0.1, 0.05, 0.05), 16,
     dict(window_rows=48, band_rows=0)),
    ("demo_settings_floor", 64, (0.3, 0.9, 0.2), (0.2, 0.2, 0.2), 8,
     dict(window_rows=16, band_rows=16, band_max_slices=32)),
)
# (name, (theta0, phi0, span))
K2_LATLONG_CASES = (("windowed", (0.3, 0.2, 0.02)), ("windowed_minified", (0.3, 0.2, 0.3)),
                    ("floor_on_seam", (np.pi - 0.05, -0.1, 0.1)))


def k2_check(device) -> float:
    """K2's device functions against the plain samplers, one batch per
    case; returns the largest |Δ|."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
    from godot_atmosphere_shader_tpu_torch.ops.kernels import texsample as ts
    from godot_atmosphere_shader_tpu_torch.utils.vecmath import Vec3

    rng = np.random.default_rng(5)
    tables = {}
    for s in (32, 64):
        data, meta = ts.build_tex3d_pyramid(rng.random((s, s, s)).astype(np.float32))
        tables[s] = (torch.as_tensor(data, device=device), meta)
    worst = 0.0
    for name, size, lo, ext, rows, kw in K2_TEX3D_CASES:
        r = np.random.default_rng(sum(map(ord, name)))
        planes = [torch.as_tensor((lo[a] + ext[a] * r.random((rows, 128))).astype(np.float32),
                                  device=device) for a in range(3)]
        table, meta = tables[size]
        ref, mode, level = ts.sample_tex3d(table, meta, *planes, return_choice=True, **kw)
        got, gmode, glevel = mk.sample_batches(table, meta, *(p.reshape(1, -1) for p in planes),
                                               **kw)
        worst = max(worst, _k2_compare(f"tex3d/{name}", got.reshape(ref.shape), ref,
                                       (int(gmode[0]), int(glevel[0])), (mode, level)))
    faces = np.random.default_rng(8).random((6, 64, 64)).astype(np.float32)
    data, meta = ts.build_latlong_pyramid(faces, width=512)
    table = torch.as_tensor(data, device=device)
    for name, (theta0, phi0, span) in K2_LATLONG_CASES:
        r = np.random.default_rng(len(name))
        theta = (theta0 + span * r.random((16, 128))).astype(np.float32)
        phi = (phi0 + span * r.random((16, 128))).astype(np.float32)
        d = [torch.as_tensor(c.astype(np.float32), device=device) for c in
             (np.cos(phi) * np.cos(theta), np.sin(phi), np.cos(phi) * np.sin(theta))]
        ref, mode, level = ts.sample_latlong(table, meta, Vec3(*d), return_choice=True)
        got, gmode, glevel = mk.sample_batches(table, meta, *(c.reshape(1, -1) for c in d))
        worst = max(worst, _k2_compare(f"latlong/{name}", got.reshape(ref.shape), ref,
                                       (int(gmode[0]), int(glevel[0])), (mode, level)))
    return worst


def _k2_compare(what, got, ref, got_choice, ref_choice) -> float:
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    log(f"[k2] {what}: mode/level kernel {got_choice} plain {ref_choice}, max |Δ| {err:.3g}")
    if got_choice != ref_choice or not err <= K2_ATOL:
        raise RuntimeError(f"K2 disagrees with its plain version on {what}")
    return err


# -- K3 alone: the cases of tests/test_torch_taa.py at 1080p ---------------------


def pose_matrix(eye, yaw=0.0, pitch=0.0) -> np.ndarray:
    """A view→world matrix at ``eye`` looking down −Z, turned by ``yaw``
    about +Y and ``pitch`` about +X (float32)."""
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    m = np.eye(4)
    m[:3, :3] = (np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                 @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]]))
    m[:3, 3] = eye
    return m.astype(np.float32)


# name: (previous pose, current pose, blend, options)
_ORIGIN = pose_matrix((0, 0, 0))
TAA_CASES = (
    ("identity", _ORIGIN, _ORIGIN, 0.25, {}),
    ("sideways_shift", pose_matrix((0.8, 0.05, 0)), _ORIGIN, 0.1, {}),
    ("turn_and_climb", pose_matrix((0.2, 0.0, 0.5), yaw=0.02),
     pose_matrix((0, 0.3, 0), pitch=-0.01), 0.3, {}),
    ("window_exit", pose_matrix((1.0, 0.1, 0)), _ORIGIN, 0.2,
     dict(near_far=(0.5, 60.0), depth_eps=1e6)),
    ("partial_tile", pose_matrix((0.5, -0.4, 0)), pose_matrix((0, 0, 0.3)), 0.2, {}),
    ("disocclusion", pose_matrix((0.5, 0.07, 0)), _ORIGIN, 0.2, dict(occluder=True)),
    ("no_history_depth", pose_matrix((0.5, 0.2, 0)), _ORIGIN, 0.2, dict(history_depth=False)),
    ("variance", pose_matrix((0.6, 0.1, 0)), _ORIGIN, 0.15,
     dict(clamp_mode="variance", clamp_gamma=1.0)),
)


def smooth_planes(h, w, seed, device, channels):
    """Seeded smooth planes (bilinear upsampling of a coarse random grid)."""
    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand((1, channels, h // 16 + 2, w // 16 + 2), generator=g)
    up = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                         align_corners=False)[0]
    return up.permute(1, 2, 0).contiguous().to(device)


def taa_case_inputs(case, h, w, device):
    name, prev, cur, blend, opt = case
    seed = sum(map(ord, name))
    color, hist = smooth_planes(h, w, seed, device, 3), smooth_planes(h, w, seed + 1, device, 3)
    field = smooth_planes(h, w, seed + 2, device, 1)[..., 0]
    near, far = opt.get("near_far", (20.0, 80.0))
    ld = (torch.where(field < 0.5, near, far) if "near_far" in opt
          else near + (far - near) * field).contiguous()
    ld[64:72, 256:384] = 3.0e7  # sky above the 1e7 clamp
    hd = ld.clone()
    if opt.get("occluder"):
        hd[h // 4:h // 2, w // 4:w // 2] *= 3.0
    if opt.get("history_depth") is False:
        hd = ld
    return color, ld, hist, hd


def taa_check(device, h, w):
    """K3 against its plain version on every case; returns the worst
    max |Δ| where validity agrees and the most flips (share of pixels)."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import taa
    from godot_atmosphere_shader_tpu_torch.utils.camera import Camera

    worst, worst_flips = 0.0, 0.0
    for case in TAA_CASES:
        name, prev, cur, blend, opt = case
        color, ld, hist, hd = taa_case_inputs(case, h, w, device)
        p = taa.taa_constants(Camera.create(prev, device="cpu"), Camera.create(cur, device="cpu"),
                              blend, h, w, h, opt.get("depth_eps", 0.2),
                              opt.get("clamp_mode", "minmax"), opt.get("clamp_gamma", 1.25))
        out, depth = torch.empty_like(color), torch.empty_like(ld)
        valid = torch.empty((h, w), dtype=torch.uint8, device=device)
        taa.launch(p, color, ld, hist, hd, out, depth, valid)
        ref, ref_depth, ref_valid = taa.resolve_plain(p, color, ld, hist, hd)
        torch.cuda.synchronize()
        flips = valid.bool() != ref_valid
        err = float((out - ref).abs().amax(dim=-1)[~flips].max())
        share = float(flips.double().mean())
        log(f"[taa] {name} {h}x{w}: max |Δ| {err:.3g} where validity agrees, validity flips "
            f"{int(flips.sum())} ({share:.3g} of pixels), valid share "
            f"{float(ref_valid.double().mean()):.3f}, depth equal {torch.equal(depth, ref_depth)}")
        if not (err <= TAA_MAX_ERR and share <= TAA_MAX_FLIPS and torch.equal(depth, ref_depth)):
            raise RuntimeError(f"K3 disagrees with its plain version on {name}")
        worst, worst_flips = max(worst, err), max(worst_flips, share)
    return worst, worst_flips


# -- flights ------------------------------------------------------------------------


def fly_path(frames: int) -> np.ndarray:
    """The avatar's flight: from the avatar pose forward at its speed (10
    units/s) with a small yaw, 1/60 s per frame; (K, 4, 4) host transforms."""
    from godot_atmosphere_shader_tpu_torch.utils.flight import FlyCamera

    fly = FlyCamera(position=(0.0, 0.0, 156.425), speed=10.0)
    stack = []
    for _ in range(frames):
        stack.append(fly.view_to_world())
        fly.look(0.002, 0.0).move((0.0, 0.0, -1.0), dt=1.0 / 60.0)
    return np.stack(stack)


def flight_times(frames: int, t0: float = 0.5) -> list:
    return [t0 + i / 60.0 for i in range(frames)]


def plain_flight(scene, cam, times, stack, h, w, blend, mesh=None):
    """The plain flight on the same CUDA inputs as ``Scene.render_flight``:
    the same layers and configs (texture plans and the sky's pyramids
    included), per-frame state rows and transforms, through
    ``render_flight_plain`` (with ``mesh``: the plain sharded TAA flight,
    ``render_flight_taa_sharded_plain``)."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import taa
    from godot_atmosphere_shader_tpu_torch.parallel.sharding import (
        render_flight_taa_sharded_plain)
    from godot_atmosphere_shader_tpu_torch.render.renderer import render_flight_plain

    order, params, configs = scene._sorted_layers(cam)
    plans = [scene._texture_plan(p, c) for p, c in zip(params, configs)]
    configs = [c for c, _ in plans]
    settings = None
    if blend is not None:
        configs = [dataclasses.replace(c, temporal_jitter=True) for c in configs]
        settings = taa.TaaSettings(blend=blend)
    near = float(cam.near)
    fs = [np.stack([atmo.frame_state_row(float(t), m[:3, 3].astype(np.float64), near)
                    for t, m in zip(np.asarray(times, np.float32), stack)]) for atmo in order]
    pano_data, pano_meta = scene._pano_plan() or (None, None)
    if mesh is not None:
        return render_flight_taa_sharded_plain(params, fs, configs, cam, scene.opaque, h, w,
                                               mesh, cam_stack=stack, blend=blend,
                                               tex_data=[t for _, t in plans],
                                               pano_data=pano_data, pano_meta=pano_meta)
    return render_flight_plain(params, fs, configs, cam, scene.opaque, h, w, cam_stack=stack,
                               tex_data=[t for _, t in plans], taa=settings,
                               pano_data=pano_data, pano_meta=pano_meta)


def check_flight(label, out, ref) -> float:
    """Each frame against the plain flight (cloud tolerance); returns the
    largest |Δ|."""
    worst = 0.0
    for i in range(out["color"].shape[0]):
        got = frame_array({"color": out["color"][i], "alpha": out["alpha"][i]})
        want = frame_array({"color": ref["color"][i], "alpha": ref["alpha"][i]})
        check_frame(got, f"{label} frame {i}")
        st = cloud_deltas(got, want)
        log(f"[flight] {label} frame {i} kernel vs plain: {json.dumps(st)}")
        if not cloud_tolerance_ok(st):
            raise RuntimeError(f"{label}: frame {i} disagrees with the plain flight")
        worst = max(worst, st["max"])
    return worst


def kernel_traces(fn, names) -> dict:
    """One call of ``fn`` under ``torch.profiler``: for each of ``names``,
    how many kernels whose name holds it ran, their mean device time and
    the mean interval between the starts of consecutive ones (µs).  A small
    kernel and a synchronisation come first inside the trace, as in
    :func:`flight_trace`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    out = {}
    for name in names:
        runs = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                      if e.device_type == DeviceType.CUDA and name in e.name)
        starts = [s for s, _ in runs]
        out[name] = {"kernels": len(runs),
                     "device_us": sum(e - s for s, e in runs) / max(len(runs), 1),
                     "interval_us": ((starts[-1] - starts[0]) / (len(starts) - 1)
                                     if len(starts) > 1 else None)}
    return out


def kernel_trace(fn, name: str) -> dict:
    """:func:`kernel_traces` of one name."""
    return kernel_traces(fn, (name,))[name]


def flight_trace(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device busy ms (union of
    device intervals), and the device→host copies in all and between the
    first and the last frame kernel (K1 or K3) of the flight.  A small
    kernel and a synchronisation come first and last inside the trace: a
    trace can miss its first or its last device events otherwise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        torch.ones(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    frames = [e for e in events if "megakernel" in e.name or "taa_kernel" in e.name]
    # a trace that caught no frame kernel reports 0 of them (and is taken again)
    first = min((e.time_range.start for e in frames), default=0.0)
    last = max((e.time_range.end for e in frames), default=0.0)
    d2h = [e for e in events if "DtoH" in e.name]
    inside = [e for e in d2h if first <= e.time_range.start <= last]
    return {"device_busy_ms": busy_us(events) / 1e3, "frame_kernels": len(frames),
            "d2h_copies": len(d2h), "d2h_copies_in_loop": len(inside)}


# -- T3: the launch route and the launch floor ---------------------------------

ROUTE_CALLS = 10_000  # calls per step of the launch route, in ROUTE_ROUNDS rounds
ROUTE_ROUNDS = 5      # the steps in turns, each round ROUTE_CALLS / ROUTE_ROUNDS calls a step


def legacy_launch_fill(fn, value: float, out: torch.Tensor) -> int:
    """The launch route every launcher of the port took before
    ``library.launch`` (``probes.launch_fill`` at d8f31fc, without its
    counter): the argument checks, a device guard, a ``Stream`` object for
    the current stream, then the ctypes call ``fn``.  Measured beside the
    route that replaced it, never used by the port."""
    if out.device.type != "cuda" or out.dtype != torch.float32 or out.dim() != 2 \
            or not out.is_contiguous():
        raise ValueError("fill needs a contiguous (h, w) float32 CUDA tensor")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        return fn(float(value), out.data_ptr(), out.shape[0], out.shape[1], stream)


def route_step_us(fn, calls: int) -> float:
    """Host µs per call of ``fn()`` over ``calls`` calls
    (``time.perf_counter_ns``), after a synchronisation."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    us = (time.perf_counter_ns() - t0) / calls / 1e3
    torch.cuda.synchronize()
    return us


def launch_route_breakdown(device) -> dict:
    """Each step of a fill launch on the host, µs per call, the median of
    :data:`ROUTE_ROUNDS` rounds that take the steps in turns (the host's
    speed drifts between seconds), :data:`ROUTE_CALLS` calls a step in
    all, on one 32×128 tile (its kernel takes less
    device time than a launch takes host time, so the launch queue never
    fills): the old route's steps (device guard, ``current_stream`` with its
    ``Stream`` object, the argument checks and ``data_ptr``), the new
    route's (the card count, the current device where there are several,
    the raw stream, its checks), a ctypes call
    into a C function that only returns (``megakernel_work_slots``), the
    ctypes call into ``fill_launch`` with its arguments ready, refused
    before the launch (an empty plane) and launching, each whole route
    (:func:`legacy_launch_fill`, ``probes.launch_fill``) and ``fill_`` on
    the same tile."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import library, probes
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    out = torch.empty((TILE, 128), device=device)
    index = out.get_device()
    fn = library.function("fill_launch", probes.FILL_ARGTYPES)
    null = mk.load_library().megakernel_work_slots
    ptr, stream = out.data_ptr(), torch._C._cuda_getCurrentRawStream(index)

    def guard():
        with torch.cuda.device(out.device):
            pass

    def old_checks():
        return (out.device.type != "cuda" or out.dtype != torch.float32 or out.dim() != 2
                or not out.is_contiguous(), out.data_ptr())

    def new_checks():
        return (out.dim() != 2, out.dtype != torch.float32 or not out.is_contiguous(),
                not out.is_cuda, out.get_device(), out.data_ptr())

    probes.launch_fill(0.0, out)  # warm
    steps = {
        "old_device_guard": guard,
        "old_current_stream_object": lambda: torch.cuda.current_stream(out.device).cuda_stream,
        "old_checks_and_data_ptr": old_checks,
        "new_current_device": torch._C._cuda_getDevice,
        "new_device_count": torch.cuda.device_count,
        "new_raw_stream": lambda: torch._C._cuda_getCurrentRawStream(index),
        "new_checks_and_data_ptr": new_checks,
        "ctypes_null_call": null,
        "ctypes_call_refused": lambda: fn(0.5, ptr, 0, 128, stream),  # returns before a launch
        "launch_only": lambda: fn(0.5, ptr, TILE, 128, stream),
        "library_fill_": lambda: out.fill_(0.5),
        "old_route": lambda: legacy_launch_fill(fn, 0.5, out),
        "new_route": lambda: probes.launch_fill(0.5, out),
    }
    rounds = {name: [] for name in steps}
    for _ in range(ROUTE_ROUNDS):
        for name, f in steps.items():
            rounds[name].append(route_step_us(f, ROUTE_CALLS // ROUTE_ROUNDS))
    t = {name: float(np.median(v)) for name, v in rounds.items()}
    t["rounds"] = rounds
    t["calls"] = ROUTE_CALLS
    t["plane"] = [TILE, 128]
    return t


def graph_floor(launch, k: int, replays: int) -> tuple:
    """``(ms a launch, graph)``: ``launch(i)``, i < ``k``, captured once
    into a ``torch.cuda.CUDAGraph`` and replayed ``replays`` times (CUDA
    events): the floor as the TPU probe's ``lax.map`` measured it, K
    launches inside one program.  Warmed up on a side stream first, as
    capture asks."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(k):
            launch(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(k):
            launch(i)
    return time_cuda(lambda i: graph.replay(), replays) / k, graph


def fill_phase(device, card: str) -> tuple:
    """T3 at 1080p: the fill kernel K times back to back into K planes, as
    the TPU probe's ``lax.map`` did (events ms a launch, in turns with
    ``fill_``; device µs; the plain version), both replayed from a CUDA graph
    of the K launches (the graph's planes checked), each against
    ``torch.full``; then :func:`launch_route_breakdown`.  Returns
    ``(fill timings, route breakdown)``."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import probes

    H, W = FULL_SIZE
    planes = torch.empty((FILL_LAUNCHES, H, W), device=device)
    views = list(planes)  # plane i by a list index: no tensor indexing in the timed loop
    for i in range(FILL_LAUNCHES):  # warm: the first launches load the module
        probes.launch_fill(float(i), views[i])
        views[i].fill_(float(i))
    torch.cuda.synchronize()
    probes.counters.reset()
    fill_rounds = {"kernel": [], "library": []}
    for r in range(FILL_ROUNDS):  # fill_kernel and fill_ in turns, K launches each
        fill_rounds["kernel"].append(time_cuda(
            lambda i: probes.launch_fill(float(i), views[i % FILL_LAUNCHES]), FILL_LAUNCHES,
            warmup=0))
        if r == 0:
            fill_launches = probes.counters.launches
        fill_rounds["library"].append(time_cuda(
            lambda i: views[i % FILL_LAUNCHES].fill_(float(i)), FILL_LAUNCHES, warmup=0))
    fill_t = {"kernel_ms": float(np.median(fill_rounds["kernel"])),
              "library_ms": float(np.median(fill_rounds["library"])), "rounds_ms": fill_rounds,
              "plain_ms": time_cuda(lambda i: probes.fill_plain(float(i), H, W, device=device),
                                    FILL_LAUNCHES)}
    fill_trace = kernel_trace(lambda: [probes.launch_fill(float(i), planes[i])
                                       for i in range(FILL_LAUNCHES)], "fill_kernel")
    library_trace = kernel_trace(lambda: [planes[i].fill_(float(i))
                                          for i in range(FILL_LAUNCHES)], "")
    probes.launch_fill(0.25, planes[0])
    fill_err = float((planes[0] - probes.fill_plain(0.25, H, W, device=device)).abs().max())
    fill_t["graph_kernel_ms"], graph = graph_floor(
        lambda i: probes.launch_fill(float(i), planes[i]), FILL_LAUNCHES, FILL_REPLAYS)
    planes.zero_()
    graph.replay()  # the captured launches write the planes
    torch.cuda.synchronize()
    graph_err = max(float((planes[i] - i).abs().max()) for i in range(FILL_LAUNCHES))
    fill_t["graph_library_ms"] = graph_floor(lambda i: planes[i].fill_(float(i)),
                                             FILL_LAUNCHES, FILL_REPLAYS)[0]
    del graph
    fill_t.update(us_per_launch=fill_t["kernel_ms"] * 1e3, launches=fill_launches,
                  device_us=fill_trace["device_us"],
                  device_interval_us=fill_trace["interval_us"],
                  library_device_us=library_trace["device_us"],
                  library_device_interval_us=library_trace["interval_us"],
                  bound_ms=(H * W * 4 + 4) / PEAK_BYTES * 1e3, max_abs_err=fill_err,
                  graph_max_abs_err=graph_err)
    log(f"[fill-time] T3 launch floor 1080p on {card}: {json.dumps(fill_t)}")
    route = launch_route_breakdown(device)
    log(f"[launch-route] host us a call on {card}: {json.dumps(route)}")
    if fill_err != 0.0 or graph_err != 0.0 or fill_launches != FILL_LAUNCHES:
        raise RuntimeError("the fill kernel disagrees with torch.full")
    return fill_t, route


# -- multi-layer scenes: the JAX bench cells ------------------------------------


def build_scene(kind: str, device, textures=None):
    """A demo variant's scene (``textures``: texture mode), ``"cell5"``
    (``clouds_high_rm`` and the moon's ``no_clouds`` atmosphere, JAX bench
    cell 5), ``"golden_chain"`` (the same with a ``v1_no_clouds`` moon, as
    ``tests/golden_images/rm_multiplanet_space.png``), ``"allon"`` (the
    everything-on scene's layers: texture ``clouds`` and the moon's
    ``no_clouds`` atmosphere; the caller sets its panorama) or
    ``"gas_giant"``."""
    from godot_atmosphere_shader_tpu_torch.models.demo import (build_demo_scene,
                                                               build_gas_giant_scene)
    from godot_atmosphere_shader_tpu_torch.models.scene import PlanetAtmosphere

    if kind == "gas_giant":
        return build_gas_giant_scene(device=device)
    if kind in ("cell5", "golden_chain", "allon"):
        scene = (build_demo_scene("clouds", procedural=False, device=device, textures=textures)
                 if kind == "allon" else build_demo_scene("clouds_high_rm", device=device))
        scene.atmospheres.append(PlanetAtmosphere(
            sun=scene.atmospheres[0].sun, device=device,
            custom_shader="v1_no_clouds" if kind == "golden_chain" else "no_clouds", **MOON))
        return scene
    return build_demo_scene(kind, procedural=textures is None, device=device, textures=textures)


def scene_camera(kind: str, pose: str, device):
    from godot_atmosphere_shader_tpu_torch.models.demo import demo_camera, gas_giant_camera

    return (gas_giant_camera if kind == "gas_giant" else demo_camera)(pose, device=device)


def scene_plan(scene, cam, h: int) -> tuple:
    """What ``Scene.render`` hands the layer chain for this frame:
    ``(params, configs, tex_data, bands, band_rows)`` of the kept layers."""
    order, params, configs = scene._sorted_layers(cam)
    plans = [scene._texture_plan(p, c) for p, c in zip(params, configs)]
    _, params, configs, tex, bands, rows = scene._layer_bands(
        order, params, tuple(c for c, _ in plans), tuple(t for _, t in plans), cam, h)
    return params, configs, tex, bands, rows


def plan_text(plan) -> str:
    _, configs, _, bands, rows = plan
    parts = [] if bands is None or bands[0] is None else ["opaque-only"]
    for i, c in enumerate(configs):
        band = "fullscreen" if bands is None or bands[i] is None else (
            f"rows {int(rows[i])}+{int(bands[i])}")
        parts.append(f"{c.model}{'/clouds' if c.clouds_enabled else ''}: {band}")
    return ", ".join(parts)


def expected_launches(plan) -> int:
    _, configs, _, bands, _ = plan
    return len(configs) + int(bands is not None and bands[0] is not None)


def sky_launch(scene, cam, plan, h: int, w: int) -> tuple:
    """The first launch of a frame's plan, ``(kind, struct, args)``: the one
    that draws the sky when the scene has a panorama."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    params, configs, tex, bands, rows = plan
    pano_data, pano_meta = scene._pano_plan() or (None, None)
    return mk.scene_launches(params, configs, cam, scene.opaque, h, w, tex_data=tex,
                             bands=bands, band_rows=rows, pano_data=pano_data,
                             pano_meta=pano_meta)[0]


def expected_choice_launches(plan, sky: bool) -> int:
    """The sky's pre-pass runs once per frame with a sky, unless a fused
    texture layer draws it (its block is the tile)."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    _, configs, _, bands, _ = plan
    fused = bands is None or bands[0] is None
    return int(sky and not (fused and mk.texture_mode(configs[0])))


def check_scene(label: str, scene, cam, h: int, w: int, ok=cloud_tolerance_ok) -> tuple:
    """``Scene.render`` through the kernel (counters: the planned launches,
    one drawing the sky when the scene has a panorama and the sky's
    pre-pass where planned, no plain call, no plain sky sampler call)
    against the plain chain on the same inputs (``ok``: the cloud
    tolerance); returns the largest |Δ| and the kernel's frame."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
    from godot_atmosphere_shader_tpu_torch.ops.kernels import texsample as ts

    plan = scene_plan(scene, cam, h)
    pano_data, pano_meta = scene._pano_plan() or (None, None)
    mk.counters.reset()
    ts.counters.reset()
    got = frame_array(scene.render(cam, h, w))
    counts = (mk.counters.megakernel_launches, mk.counters.sky_launches,
              mk.counters.sky_choice_launches,
              mk.counters.plain_calls + ts.counters.plain_sky_calls)
    params, configs, tex, bands, rows = plan
    ref = frame_array(mk.render_scene_plain(params, configs, cam, scene.opaque, h, w,
                                            tex_data=tex, bands=bands, band_rows=rows,
                                            pano_data=pano_data, pano_meta=pano_meta))
    check_frame(got, f"kernel {label}")
    check_frame(ref, f"plain {label}")
    st = cloud_deltas(got, ref)
    log(f"[scene] {label} {h}x{w}: plan [{plan_text(plan)}], counters K1 {counts[0]}, "
        f"sky {counts[1]}, sky pre-pass {counts[2]}, plain {counts[3]}; kernel vs plain: "
        f"{json.dumps(st)}")
    sky = pano_data is not None
    if counts != (expected_launches(plan), int(sky), expected_choice_launches(plan, sky), 0):
        raise RuntimeError(f"{label}: the frame did not go through the planned K1 launches only")
    if not ok(st):
        raise RuntimeError(f"{label}: kernel disagrees with plain")
    return st["max"], got


def limb_deltas(got: np.ndarray, ref: np.ndarray, max_abs: float = GAS_GIANT_MAX) -> dict:
    """The gas-giant golden's statistics of ``got`` against ``ref`` (both
    (H, W, 4)): pixels off at atol 1e-5 / rtol 1e-4, the largest |Δ|,
    pixels off by more than ``max_abs``, whether every pixel off is a ray
    through the shell (``ref`` alpha > 0), the worst pixel; ``ok``: within
    the golden's budget (with ``max_abs`` for its largest |Δ|)."""
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64)).max(axis=-1)
    worst = np.unravel_index(int(d.argmax()), d.shape)
    st = {"off": int(bad.sum()), "share": float(bad.mean()), "max": float(d.max()),
          "above_max": int((d > max_abs).sum()),
          "shell_only": bool((ref[..., 3][bad] > 0.0).all()),
          "worst_pixel": [int(worst[0]), int(worst[1])]}
    st["ok"] = (st["share"] <= GAS_GIANT_SHARE and st["above_max"] == 0 and st["shell_only"])
    return st


def ulp_label(move) -> str:
    axis, sign = move
    return f"{'xyz'[axis]}{'+' if sign > 0 else '-'}"


def gas_giant_frames(device, move=None) -> dict:
    """The gas giant's limb band (GAS_GIANT_SIZE, the golden's scene and
    pose at t = 0.5; ``move``: ``(axis, sign)``, the camera's position
    moved along that axis that way by one ulp of its largest coordinate)
    through ``Scene.render`` on ``device``:
    the kernel's frame on a card (``"kernel"``) and the plain chain on the
    same inputs (``"plain"``), or the plain chain alone on the CPU."""
    from godot_atmosphere_shader_tpu_torch.models.demo import (build_gas_giant_scene,
                                                               gas_giant_camera)
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    h, w = GAS_GIANT_SIZE
    scene = build_gas_giant_scene(device=device)
    cam = gas_giant_camera("limb", device=device)
    if move is not None:
        axis, sign = move
        v2w = cam.view_to_world.clone()
        far = v2w[:3, 3].abs().max()
        v2w[axis, 3] += sign * (torch.nextafter(far, far + 1) - far)
        cam = dataclasses.replace(cam, view_to_world=v2w)
    scene.update(0.5, cam)
    params, configs, tex, bands, rows = scene_plan(scene, cam, h)
    plain = frame_array(mk.render_scene_plain(params, configs, cam, scene.opaque, h, w,
                                              tex_data=tex, bands=bands, band_rows=rows))
    if torch.device(device).type == "cpu":
        return {"plain": plain}
    mk.counters.reset()
    kernel = frame_array(scene.render(cam, h, w))
    if (mk.counters.clear_launches != mk.counters.megakernel_launches
            or mk.counters.plain_calls or bands is None):
        raise RuntimeError("the gas giant's band did not go through the cloud-free instance")
    return {"kernel": kernel, "plain": plain}


def gas_giant_ulp_bound(conditioning: dict) -> tuple:
    """The kernel's bound on its largest |Δ| from the plain frames' one-ulp
    moves (``conditioning``: {move: {frame: limb_deltas}}): GAS_GIANT_MAX,
    or GAS_GIANT_ULP_MARGIN times the largest move where that is more;
    returns ``(bound, largest move)``."""
    largest = max(st["max"] for frames in conditioning.values()
                  for name, st in frames.items() if name.startswith("plain"))
    return max(GAS_GIANT_MAX, GAS_GIANT_ULP_MARGIN * largest), largest


def gas_giant_check(device) -> dict:
    """Phase 3i: the gas giant's limb band on the card against three
    references, and what rounding alone does to it.  The kernel's band, the
    plain chain on the card and on the CPU, and the JAX XLA frame
    (GAS_GIANT_REF), each pair under the golden's statistics
    (:func:`limb_deltas`), and the conditioning: each frame against itself
    with the camera one ulp away along each axis, each way (ULP_MOVES).
    The kernel is held against each reference to the golden's budget, its
    largest |Δ| to :func:`gas_giant_ulp_bound` of the plain frames' moves
    (the share and the shell rule stay); raises if it misses."""
    card = gas_giant_frames(device)
    frames = {"kernel": card["kernel"], "plain_card": card["plain"],
              "plain_cpu": gas_giant_frames("cpu")["plain"],
              "jax_xla": np.load(GAS_GIANT_REF)["frame"]}
    for name, img in frames.items():
        check_frame(img, f"gas giant {name}")
    names = list(frames)
    pairs = {f"{a} vs {b}": limb_deltas(frames[a], frames[b])
             for i, a in enumerate(names) for b in names[i + 1:]}
    conditioning = {}
    for move in ULP_MOVES:
        moved_card = gas_giant_frames(device, move)
        moved_cpu = gas_giant_frames("cpu", move)
        conditioning[ulp_label(move)] = {
            "kernel": limb_deltas(moved_card["kernel"], card["kernel"]),
            "plain_card": limb_deltas(moved_card["plain"], card["plain"]),
            "plain_cpu": limb_deltas(moved_cpu["plain"], frames["plain_cpu"])}
    max_abs, largest = gas_giant_ulp_bound(conditioning)
    held = {ref: limb_deltas(frames["kernel"], frames[ref], max_abs)
            for ref in ("plain_card", "plain_cpu", "jax_xla")}
    out = {"pairs": pairs, "one_ulp_of_the_camera": conditioning,
           "largest_plain_one_ulp_move": largest, "max_abs": max_abs, "kernel": held}
    h, w = GAS_GIANT_SIZE
    for name, st in pairs.items():
        log(f"[gas-giant] limb band {h}x{w}, {name}: {json.dumps(st)}")
    for move, by_frame in conditioning.items():
        for name, st in by_frame.items():
            log(f"[gas-giant] limb band {h}x{w}, {name} with the camera one ulp {move} against "
                f"itself: {json.dumps(st)}")
    for ref, st in held.items():
        log(f"[gas-giant] limb band {h}x{w}, kernel vs {ref} under the budget with max |Δ| "
            f"{max_abs} (the plain frames' largest one-ulp move {largest}): {json.dumps(st)}")
        if not st["ok"]:
            raise RuntimeError(f"the gas giant's band: the kernel misses its budget against "
                               f"{ref}: {st}")
    return out


def deep_tex3d_pyramid(tex: torch.Tensor) -> tuple:
    """A cubic shape texture's mip pyramid down to one texel (the port's
    builder stops at 8³), box-filtered and packed as
    ``texsample.build_tex3d_pyramid`` packs its levels: ``(table on the
    texture's device, TexMeta)``."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import texsample as ts

    cur = tex.detach().cpu().numpy()
    flat, metas, base = [], [], 0
    while True:
        f = cur.ravel()
        flat.append(np.pad(f, (0, (-f.size) % ts.LANES)))
        metas.append((cur.shape[0], base))
        base += flat[-1].size // ts.LANES
        if cur.shape[0] == 1:
            break
        h = cur.shape[0] // 2
        cur = cur.reshape(h, 2, h, 2, h, 2).mean(axis=(1, 3, 5))
    data = ts._pack_flat(flat)
    return (torch.as_tensor(data, device=tex.device),
            ts.TexMeta(kind="tex3d", levels=tuple(metas), rows=data.shape[0]))


def tex_envelope_scene(changes: dict, device, textures, pose: str = "avatar", t: float = 0.5):
    """The texture ``clouds_high`` scene (``textures``: the demo's baked
    shape texture and coverage cubemap) with its layer's config changed:
    ``coverage`` or ``shape`` = ``"procedural"`` replaces that baked field
    by the demo's procedural one (``COVERAGE_NOISE`` at ``COVERAGE_SCALE``,
    ``SHAPE_NOISE_FAST`` over the texture's period; per step unless the
    field's knot flag is set); ``levels`` = n makes the shape texture 4×
    larger per axis (nearest) and gives it a pyramid of n levels down to
    one texel (:func:`deep_tex3d_pyramid`), in the scene's pyramid cache;
    every other key is a ``VariantConfig`` field.  Updated at ``t``."""
    from godot_atmosphere_shader_tpu_torch.models.demo import (COVERAGE_NOISE, COVERAGE_SCALE,
                                                               SHAPE_NOISE_FAST,
                                                               SHAPE_TEXTURE_SIZE,
                                                               build_demo_scene, demo_camera)
    from godot_atmosphere_shader_tpu_torch.models.params import ProceduralField

    changes = dict(changes)
    if changes.pop("coverage", None) == "procedural":
        changes["cloud_coverage_noise"] = ProceduralField(COVERAGE_NOISE, COVERAGE_SCALE)
    if changes.pop("shape", None) == "procedural":
        changes["cloud_shape_noise"] = ProceduralField(SHAPE_NOISE_FAST,
                                                       (float(SHAPE_TEXTURE_SIZE),) * 3)
    levels = changes.pop("levels", None)
    shape_tex, cubemap = textures
    if levels:
        shape_tex = shape_tex.repeat_interleave(4, 0).repeat_interleave(4, 1).repeat_interleave(4, 2)
    scene = build_demo_scene("clouds_high", procedural=False, device=device,
                             textures=(shape_tex, cubemap))
    atmo = scene.atmospheres[0]
    atmo.set_custom_shader(dataclasses.replace(atmo.config, **changes))
    cam = demo_camera(pose, device=device)
    scene.update(t, cam)
    if levels:
        stored = scene._sorted_layers(cam)[1][0].cloud_shape_texture
        table, meta = deep_tex3d_pyramid(stored)
        if len(meta.levels) != levels:
            raise RuntimeError(f"a pyramid of {len(meta.levels)} levels, not {levels}")
        scene._tex_pyr_cache[(id(stored), "tex3d")] = (stored, (table, meta))
    return scene, cam


def plain_scene_frame(scene, cam, h: int, w: int) -> np.ndarray:
    """The plain chain of what ``Scene.render`` hands the kernel."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    params, configs, tex, bands, rows = scene_plan(scene, cam, h)
    return frame_array(mk.render_scene_plain(params, configs, cam, scene.opaque, h, w,
                                             tex_data=tex, bands=bands, band_rows=rows))


def tex_envelope_conditioning(device, textures, h: int, w: int) -> dict:
    """What one ulp moves a texture-mode plain frame by, on the card: at
    full quality (the detail knots sampled at pos·15) the camera one ulp
    further along z; over coverage groups of 32 rows every march span one
    ulp longer (:func:`spans_one_ulp_longer`)."""
    out = {}
    scene, cam = tex_envelope_scene(TEX_ENVELOPE_CASES["full quality"], device, textures)
    a = plain_scene_frame(scene, cam, h, w)
    v2w = cam.view_to_world.clone()
    v2w[2, 3] = torch.nextafter(v2w[2, 3], torch.tensor(1e9, device=device))
    cam2 = dataclasses.replace(cam, view_to_world=v2w)
    scene.update(0.5, cam2)
    out["full quality"] = cloud_deltas(a, plain_scene_frame(scene, cam2, h, w))
    scene, cam = tex_envelope_scene(TEX_ENVELOPE_CASES["G = 32"], device, textures)
    a = plain_scene_frame(scene, cam, h, w)
    with spans_one_ulp_longer():
        out["G = 32"] = cloud_deltas(a, plain_scene_frame(scene, cam, h, w))
    return out


def tex_envelope_tolerance(config, conditioning: dict) -> tuple:
    """The tolerance a texture-envelope frame is held to, and its name: the
    detail tolerance at full quality and the knot-group tolerance over
    coverage groups of 32 rows, each only where its one-ulp measurement
    (:func:`tex_envelope_conditioning`) leaves the cloud tolerance; else
    the cloud tolerance."""
    if (not config.clouds_always_low_quality
            and not cloud_tolerance_ok(conditioning["full quality"])):
        return detail_tolerance_ok, "detail"
    if (config.cloud_lod * config.cloud_coverage_lod == TILE
            and not cloud_tolerance_ok(conditioning["G = 32"])):
        return knot_group_tolerance_ok, "knot group"
    return cloud_tolerance_ok, "cloud"


def tex_choice_check(scene, cam, h: int, w: int, device) -> dict:
    """The tile choices of a one-layer texture frame's launch through the
    general texture instance (the buffer its tile pass wrote, as
    ``mk.launch(general=True)`` returns it) against their plain version
    (``mk.tex_choices_plain``, the plain chain's own samplers) on the same
    inputs: ``{"slots": compared, "tiles": tiles, "differ": slots whose
    (mode, level) differ, "max_abs": their largest |Δ|, "plain_ms": the
    plain version's wall time}``; exact is ``differ == 0``."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    params, configs, tex, bands, rows = scene_plan(scene, cam, h)
    (_, struct, args), = mk.scene_launches(params, configs, cam, scene.opaque, h, w, tex_data=tex,
                                           bands=bands, band_rows=rows)
    color = torch.empty((h, w, 3), device=device)
    alpha = torch.empty((h, w), device=device)
    got = mk.launch(struct, color, alpha, general=True, **args).cpu()
    torch.cuda.synchronize()
    t0 = time.time()
    ref = mk.tex_choices_plain(params[0], configs[0], cam, scene.opaque, h, w, tex[0])
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    ref = ref.cpu()
    if got.shape != ref.shape:
        raise RuntimeError(f"tile choice of shape {tuple(got.shape)}, plain {tuple(ref.shape)}")
    return {"slots": got.shape[0] * got.shape[1], "tiles": got.shape[0],
            "differ": int((got != ref).any(dim=2).sum()),
            "max_abs": int((got - ref).abs().max()), "plain_ms": plain_ms}


def tex_envelope_check(device, textures, h: int, w: int, conditioning: dict) -> dict:
    """Phase 3h: each case of TEX_ENVELOPE_CASES through ``Scene.render``
    (one launch of a texture instance, no plain call) against the plain
    chain on the same inputs, under :func:`tex_envelope_tolerance`; which
    instance rendered it; the general instance's tile choices against their
    plain version (:func:`tex_choice_check`: exact)."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    out = {}
    for name, changes in TEX_ENVELOPE_CASES.items():
        scene, cam = tex_envelope_scene(changes, device, textures)
        config = scene_plan(scene, cam, h)[1][0]
        mk.check_config(config)
        ok, tolerance = tex_envelope_tolerance(config, conditioning)
        err, _ = check_scene(f"texture envelope {name}", scene, cam, h, w, ok)
        if mk.counters.texture_launches != 1:
            raise RuntimeError(f"texture envelope {name}: not rendered by a texture instance")
        general = mk.counters.texture_general_launches
        if mk.counters.tex_choice_launches != general:
            raise RuntimeError(f"texture envelope {name}: the general instance without its tile "
                               f"choice")
        choice = tex_choice_check(scene, cam, h, w, device)
        if choice["differ"]:
            raise RuntimeError(f"texture envelope {name}: the tile choice differs from plain in "
                               f"{choice['differ']} of {choice['slots']} slots")
        out[name] = {"max": err, "tolerance": tolerance,
                     "instance": "general" if general else "fixed", "choice_slots": choice["slots"]}
    return out


def tex_envelope_timing(scene, cam, h: int, w: int, device, plain_s: float) -> dict:
    """Phase 4g's timing of one frame: its texture launch (the general
    instance's two: the tile pass and the frame) alone, CUDA events
    over both, and each one's device time from ``torch.profiler``, with
    each one's bound from the work counters and the two launches'
    together (:func:`tex_general_roofline`), ``Scene.render`` ms and idle share, the plain ms
    (``plain_s``: the whole plain frame's wall time) and what its instance
    uses (``mk.tex_info``)."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    params, configs, tex, bands, rows = scene_plan(scene, cam, h)
    (_, struct, args), = mk.scene_launches(params, configs, cam, scene.opaque, h, w, tex_data=tex,
                                           bands=bands, band_rows=rows)
    color = torch.empty((h, w, 3), device=device)
    alpha = torch.empty((h, w), device=device)

    def launch(i=0):
        mk.launch(struct, color, alpha, **args)

    def frame(i):
        scene.update(0.5 + 0.05 * i, cam)
        scene.render(cam, h, w)

    trace = kernel_traces(lambda: [launch() for _ in range(ENVELOPE_KERNEL_FRAMES)],
                          ("megakernel_tex", "tex_choice_kernel"))
    frame_dev = trace["megakernel_tex"]["device_us"] / 1e3
    choice_dev = trace["tex_choice_kernel"]["device_us"] / 1e3
    t = {"kernel_ms": time_cuda(launch, ENVELOPE_KERNEL_FRAMES),
         "device_ms": frame_dev + choice_dev, "frame_device_ms": frame_dev,
         "choice_device_ms": choice_dev, "scene_ms": time_cuda(frame, ENVELOPE_KERNEL_FRAMES)}
    busy, _ = device_busy_ms(frame, ENVELOPE_KERNEL_FRAMES, first=2 + ENVELOPE_KERNEL_FRAMES)
    t["scene_device_busy_ms"] = busy
    t["scene_idle_share"] = 1.0 - busy / t["scene_ms"] if busy > 0 else None
    scene.update(0.5, cam)
    work = mk.work_counts(struct, color, alpha, **args)
    table_bytes = sum(x.numel() * 4 for x in tex[0] if x is not None)
    b = tex_general_roofline(work, configs[0], struct, args["tex"][0], table_bytes,
                             h * w * BYTES_LAYER_PIXEL, extra_ops=geometry_ops(struct, work))
    t.update(work=work, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
             frame_bound_ms=b["frame"]["bound_ms"], frame_bound_by=b["frame"]["bound_by"],
             choice_bound_ms=b["tile"]["bound_ms"], choice_bound_by=b["tile"]["bound_by"])
    t["plain_ms"] = plain_s * 1e3
    t["instance"] = mk.tex_info(struct, args["tex"][0])
    return t


def both_texture_instances(device, textures, h: int, w: int) -> dict:
    """Bench cell 6 (``clouds_high`` texture at avatar, the demo's profile)
    through both texture instances: the fixed one, as the launcher picks
    it, and the general one, which the launcher takes when asked for it
    (``mk.launch(general=True)``); each launch timed (events and device
    time), the two frames compared."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    scene, cam = scene_and_camera("clouds_high", "avatar", device, textures=textures)
    params, configs, tex, bands, rows = scene_plan(scene, cam, h)
    (_, struct, args), = mk.scene_launches(params, configs, cam, scene.opaque, h, w, tex_data=tex,
                                           bands=bands, band_rows=rows)
    out, frames = {}, {}
    for name in ("fixed", "general"):
        color = torch.empty((h, w, 3), device=device)
        alpha = torch.empty((h, w), device=device)
        general = name == "general"

        def launch(i=0, general=general, color=color, alpha=alpha):
            mk.launch(struct, color, alpha, general=general, **args)

        mk.counters.reset()
        launch()
        if mk.counters.texture_general_launches != general:
            raise RuntimeError(f"bench cell 6: the launcher did not launch the {name} instance")
        frames[name] = frame_array({"color": color, "alpha": alpha})
        trace = kernel_traces(lambda: [launch() for _ in range(ENVELOPE_KERNEL_FRAMES)],
                              ("megakernel_tex", "tex_choice_kernel"))
        out[name] = {"ms": time_cuda(launch, ENVELOPE_KERNEL_FRAMES),
                     "device_ms": sum(x["device_us"] for x in trace.values()) / 1e3,
                     "choice_device_ms": trace["tex_choice_kernel"]["device_us"] / 1e3,
                     "instance": mk.tex_info(struct, args["tex"][0], general)}
    out["general_vs_fixed"] = cloud_deltas(frames["general"], frames["fixed"])
    out["bit_equal"] = bool(np.array_equal(frames["general"], frames["fixed"]))
    return out


def tex_envelope_frames(device, textures, h: int, w: int, conditioning: dict) -> dict:
    """Phase 4g: the frames of TEX_ENVELOPE_FRAMES through ``Scene.render``
    (counters: one launch of the general texture instance each, no plain
    call), each held against the whole plain frame on the same inputs under
    :func:`tex_envelope_tolerance`, then timed (:func:`tex_envelope_timing`).
    Returns ``{"launches": the general instance's launches, "frames":
    {name: timing, check and tolerance}}``."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
    from godot_atmosphere_shader_tpu_torch.ops.kernels import texsample as ts

    runs = {}
    mk.counters.reset()
    ts.counters.reset()
    for name, changes in TEX_ENVELOPE_FRAMES.items():
        scene, cam = tex_envelope_scene(changes, device, textures)
        runs[name] = (scene, cam, frame_array(scene.render(cam, h, w)))
    torch.cuda.synchronize()
    counts = (mk.counters.megakernel_launches, mk.counters.texture_launches,
              mk.counters.texture_general_launches, mk.counters.tex_choice_launches,
              mk.counters.plain_calls + ts.counters.plain_sky_calls)
    log(f"[tex-envelope] counters after {len(runs)} {h}x{w} Scene.render frames: K1 {counts[0]}, "
        f"texture {counts[1]} (general {counts[2]}, its tile pass {counts[3]}), plain "
        f"{counts[4]}")
    if counts != (len(runs),) * 4 + (0,):
        raise RuntimeError("the texture envelope's frames did not all go through the general "
                           "texture instance and its tile pass")
    out = {"launches": counts[2], "choice_launches": counts[3], "frames": {}}
    choices = {}
    for name, (scene, cam, img) in runs.items():
        check_frame(img, f"{h}x{w} {name}")
        config = scene_plan(scene, cam, h)[1][0]
        ok, tolerance = tex_envelope_tolerance(config, conditioning)
        torch.cuda.synchronize()
        t0 = time.time()
        ref = plain_scene_frame(scene, cam, h, w)
        plain_s = time.time() - t0
        st = cloud_deltas(img, ref)
        log(f"[tex-envelope] {name} {h}x{w} kernel vs the whole plain frame ({tolerance} "
            f"tolerance): {json.dumps(st)}")
        if not ok(st):
            raise RuntimeError(f"{name}: the {h}x{w} kernel frame disagrees with plain")
        choices[name] = tex_choice_check(scene, cam, h, w, device)
        log(f"[tex-envelope] {name} {h}x{w} tile choice vs plain: {json.dumps(choices[name])}")
        out["frames"][name] = dict(tex_envelope_timing(scene, cam, h, w, device, plain_s),
                                   check=st, tolerance=tolerance, choice=choices[name])
    differ = {k: v["differ"] for k, v in choices.items() if v["differ"]}
    if differ:
        raise RuntimeError(f"the {h}x{w} tile choices differ from plain: {differ}")
    return out


def opaque_only_check(device, h: int, w: int, pano=None) -> float:
    """The opaque-only launch of cell 5's plan alone (with ``pano`` as its
    panorama sky, if given) against the plain opaque-only frame (color,
    alpha 0, linear depth)."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
    from godot_atmosphere_shader_tpu_torch.render.renderer import opaque_only_config, render_frame

    scene = build_scene("cell5", device)
    if pano is not None:
        with_panorama(scene, pano)
    cam = scene_camera("cell5", "space", device)
    scene.update(0.5, cam)
    params, configs, tex, bands, rows = scene_plan(scene, cam, h)
    pano_data, pano_meta = scene._pano_plan() or (None, None)
    kind, struct, args = mk.scene_launches(params, configs, cam, scene.opaque, h, w,
                                           tex_data=tex, bands=bands, band_rows=rows,
                                           pano_data=pano_data, pano_meta=pano_meta)[0]
    if kind != "opaque" or struct.with_sky != int(pano is not None):
        raise RuntimeError("cell 5's plan does not start with the opaque-only pass")
    color = torch.empty((h, w, 3), device=device)
    alpha = torch.empty((h, w), device=device)
    depth = torch.empty((h, w), device=device)
    mk.launch(struct, color, alpha, depth=depth, **args)
    ref = render_frame(params[0], opaque_only_config(configs[0]), cam, scene.opaque, h, w,
                       with_atmosphere=False, pano_data=pano_data, pano_meta=pano_meta)
    got = frame_array({"color": color, "alpha": alpha})
    st = cloud_deltas(got, frame_array(ref))
    depth_off = float(((depth - ref["linear_depth"]).abs() > 1e-3 * ref["linear_depth"])
                      .double().mean())
    log(f"[scene] opaque-only pass{' with the sky' if pano is not None else ''} {h}x{w} "
        f"kernel vs plain: {json.dumps(st)}, alpha max "
        f"{float(alpha.abs().max())}, depth off by > 1e-3 rel on {depth_off:.3g} of pixels")
    if not cloud_tolerance_ok(st) or float(alpha.abs().max()) != 0.0 or depth_off > 1e-3:
        raise RuntimeError("the opaque-only pass disagrees with plain")
    return st["max"]


def space_path(frames: int) -> np.ndarray:
    """From the space pose, sliding sideways and in while looking at the
    planet, both atmospheres in view; (K, 4, 4) host transforms."""
    from godot_atmosphere_shader_tpu_torch.utils.camera import look_at

    return np.stack([look_at((0.4 * i, 150.0, 420.0 - 0.6 * i), (0.0, 0.0, 0.0),
                             device="cpu").numpy().astype(np.float32)
                     for i in range(frames)])


def launch_timing(plan, scene, cam, h, w, device) -> dict:
    """Each launch of a frame's plan timed alone (CUDA events; its device
    time from a ``torch.profiler`` trace) with its roofline bound from its
    work counters, and the whole sequence; a cloud-free launch with what
    its instance uses (``mk.clear_info``).  A launch that draws the sky (its
    pre-pass included) is also timed with the sky off (the same struct,
    ``with_sky`` 0), in turns: sky, none, none, sky."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    params, configs, tex, bands, rows = plan
    pano_data, pano_meta = scene._pano_plan() or (None, None)
    launches = mk.scene_launches(params, configs, cam, scene.opaque, h, w, tex_data=tex,
                                 bands=bands, band_rows=rows, pano_data=pano_data,
                                 pano_meta=pano_meta)
    color = torch.empty((h, w, 3), device=device)
    alpha = torch.empty((h, w), device=device)
    depth = torch.empty((h, w), device=device)
    for _, struct, args in launches:  # the planes the chained launches read
        mk.launch(struct, color, alpha, depth=depth, **args)
    layer_of = ([0] if launches[0][0] == "opaque" else []) + list(range(len(configs)))
    out, bound = [], 0.0
    def timed(st, a):
        return time_cuda(lambda i: mk.launch(st, color, alpha, depth=depth, **a), KERNEL_FRAMES)

    for (kind, struct, args), li in zip(launches, layer_of):
        extra, cost = {}, {}
        if struct.with_sky:
            no_sky = mk.MegakernelParams.from_buffer_copy(struct)
            no_sky.with_sky = 0
            runs = {"sky": [], "none": []}
            for which in ("sky", "none", "none", "sky"):
                runs[which].append(timed(struct, args) if which == "sky"
                                   else timed(no_sky, dict(args, sky=None)))
            ms = min(runs["sky"])
            extra = {"sky_runs_ms": runs["sky"], "no_sky_ms": min(runs["none"]),
                     "no_sky_runs_ms": runs["none"]}
            cost = sky_cost(cam, h, w, pano_meta, in_block=args["tex"] is not None)
        else:
            ms = timed(struct, args)
        extra["device_ms"] = kernel_trace(lambda st=struct, a=args: [
            mk.launch(st, color, alpha, depth=depth, **a) for _ in range(KERNEL_FRAMES)],
            "megakernel")["device_us"] / 1e3
        if not (struct.clouds_enabled and struct.with_atmosphere):
            extra["instance"] = mk.clear_info(struct)
        work = mk.work_counts(struct, color, alpha, depth=depth, **args)
        per_px = (BYTES_OPAQUE_PIXEL if kind == "opaque" else BYTES_CHAINED_PIXEL
                  if struct.with_background else BYTES_LAYER_PIXEL)
        tl = args["tex"]
        table_bytes = 0 if tl is None else sum(x.numel() * 4 for x in tl[1:])
        b = roofline(work, configs[li], h, w, table_bytes, frame_bytes=struct.rows * w * per_px,
                     sky_bytes=cost.get("sky_bytes", 0),
                     sky_choice_ops=cost.get("sky_choice_ops", 0),
                     extra_ops=geometry_ops(struct, work))
        bound += b["bound_ms"]
        out.append({"kind": kind, "layer": li, "row0": struct.row0, "rows": struct.rows,
                    "sky": bool(struct.with_sky), "ms": ms, **extra, **b,
                    "sky_levels": cost.get("sky_levels"), "work": work})

    def frame(i):
        for _, st, args in launches:
            mk.launch(st, color, alpha, depth=depth, **args)

    return {"launches": out, "frame_kernel_ms": time_cuda(frame, KERNEL_FRAMES),
            "frame_bound_ms": bound, "launches_per_frame": len(launches)}


def k2_planes(kind: str, device, b: int, n: int) -> list:
    """``(b, n)`` coordinate planes of K2 alone at 1080p-sized batches:
    for ``tex3d`` the banded case's coordinate range; for ``latlong`` unit
    directions, each batch within its own patch of 0.02 (windowed) to 0.3
    rad (coarser levels or the floor) at a seeded latitude and longitude."""
    g = torch.Generator(device=device).manual_seed(11)
    if kind == "tex3d":
        _, _, lo, ext, _, _ = K2_TEX3D_CASES[2]
        return [lo[a] + ext[a] * torch.rand((b, n), device=device, generator=g)
                for a in range(3)]
    theta0, phi0 = (torch.rand((2, b, 1), device=device, generator=g) - 0.5) * \
        torch.tensor([6.0, 2.4], device=device)[:, None, None]
    span = torch.tensor([0.02, 0.1, 0.3], device=device)[torch.arange(b, device=device) % 3, None]
    theta, phi = (x0 + span * torch.rand((b, n), device=device, generator=g)
                  for x0 in (theta0, phi0))
    return [torch.cos(phi) * torch.cos(theta), torch.sin(phi), torch.cos(phi) * torch.sin(theta)]


def k2_timing(device) -> dict:
    """K2 alone (T1: ``sample_batches``) at 1080p-sized batches: one per
    32×128 tile and shape knot group (34 × 15 tiles × 3 groups of up to 8
    knots), 8 × 1024 samples each, on the demo's 64³ shape pyramid
    (``tex3d``, the banded case's coordinate range) and on a 6×64² cubemap's
    lat-long pyramid (``latlong``, :func:`k2_planes`).  Per kind: the
    plain samplers on the same planes (the same mode and level in every
    batch, values within ``K2_ATOL``), ms by CUDA events, device ms
    (``torch.profiler``), the wrapper's host ms per call (all of it; its
    ``VariantConfig`` and ``tex_constants``; the two ``.long()`` of the
    choices), the plan (``mk.texsample_plan``) and the bound from the
    samples' operations and bytes."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
    from godot_atmosphere_shader_tpu_torch.ops.kernels import texsample as ts
    from godot_atmosphere_shader_tpu_torch.utils.vecmath import Vec3

    rng = np.random.default_rng(5)
    pyramids = {"tex3d": ts.build_tex3d_pyramid(rng.random((64, 64, 64)).astype(np.float32)),
                "latlong": ts.build_latlong_pyramid(rng.random((6, 64, 64)).astype(np.float32),
                                                    width=512)}
    kw = {"tex3d": K2_TEX3D_CASES[2][5], "latlong": {}}
    b, n = 34 * 15 * 3, 8 * 1024
    out = {}
    for kind, (data, meta) in pyramids.items():
        table = torch.as_tensor(data, device=device)
        planes = k2_planes(kind, device, b, n)
        args = dict(window_rows=16, band_rows=16, band_max_slices=32)
        args.update(kw[kind])

        def plain():
            if kind == "tex3d":
                return ts._tex3d_batches(table.reshape(-1), meta, *planes, args["window_rows"],
                                         args["band_rows"], args["band_max_slices"])
            return ts._latlong_batches(table.reshape(-1), meta, Vec3(*planes),
                                       args["window_rows"])

        def kernel(i=0):
            return mk.sample_batches(table, meta, *planes, **args)

        mk.counters.reset()
        got, mode, level = kernel()
        ref = plain()
        torch.cuda.synchronize()
        err = float((got - ref[0]).abs().max())
        same = bool(torch.equal(mode, ref[1].long().reshape(mode.shape))
                    and torch.equal(level, ref[2].long().reshape(level.shape)))
        host = []
        for i in range(KERNEL_FRAMES):
            t0 = time.perf_counter()
            kernel()
            host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1000):
            cfg = mk.VariantConfig(texture_window_rows=args["window_rows"],
                                   texture_band_rows=args["band_rows"],
                                   texture_band_max_slices=args["band_max_slices"])
            (mk.tex_constants(cfg, shape=meta) if kind == "tex3d"
             else mk.tex_constants(cfg, coverage=meta))
        constants_ms = time.perf_counter() - t0  # s for 1000 calls: ms a call
        choice = torch.zeros((b, 2), dtype=torch.int32, device=device)
        t0 = time.perf_counter()
        for i in range(1000):
            choice[:, 0].long(), choice[:, 1].long()
        long_ms = time.perf_counter() - t0
        torch.cuda.synchronize()
        t = {"batches": b, "samples_per_batch": n, "max_abs_err": err,
             "same_mode_and_level": same,
             "modes": {int(m): int((mode == m).sum()) for m in mode.unique()},
             "plan": mk.texsample_plan(b, n, True, kind == "tex3d"),
             "ms": time_cuda(kernel, KERNEL_FRAMES),
             "device_ms": kernel_trace(lambda: [kernel() for _ in range(KERNEL_FRAMES)],
                                       "texsample_kernel")["device_us"] / 1e3,
             "host_ms": sorted(host)[len(host) // 2] * 1e3,
             "host_constants_ms": constants_ms, "host_long_ms": long_ms,
             "plain_ms": time_cuda(lambda i: plain(), 1, warmup=0),
             "library_ms": None, "launches": mk.counters.texsample_launches}
        if kind == "tex3d":
            t["case"] = K2_TEX3D_CASES[2][0]
        samples = b * n
        t_ops = ops_time_ms(samples * (OPS_TEX3D if kind == "tex3d" else OPS_K2_LATLONG))
        t_bytes = (samples * 16 + table.numel() * 4) / PEAK_BYTES * 1e3
        t.update(bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes")
        if not (err <= K2_ATOL and same):
            raise RuntimeError(f"K2 alone ({kind}) disagrees with its plain samplers at "
                               "1080p-sized batches")
        out[kind] = t
    return out


# -- row shards (K1 slice (g)) and K3's band mode ------------------------------------


def shard_inputs(scene, cam) -> tuple:
    """What the band entries take for a frame of ``scene``: every layer far
    to near (the shard split takes the band plan's place), each with its
    texture plan, and the sky's pyramids: ``(params, configs, tex_data,
    pano_data, pano_meta)``."""
    _, params, configs = scene._sorted_layers(cam)
    plans = [scene._texture_plan(p, c) for p, c in zip(params, configs)]
    pano_data, pano_meta = scene._pano_plan() or (None, None)
    return params, tuple(c for c, _ in plans), tuple(t for _, t in plans), pano_data, pano_meta


def band_counts() -> tuple:
    """(K1, sky, sky pre-pass launches, plain calls) since the last reset."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
    from godot_atmosphere_shader_tpu_torch.ops.kernels import texsample as ts

    return (mk.counters.megakernel_launches, mk.counters.sky_launches,
            mk.counters.sky_choice_launches,
            mk.counters.plain_calls + ts.counters.plain_sky_calls)


def expected_band_counts(configs, n: int, sky: bool) -> tuple:
    """n shards of a frame: one K1 launch per layer and shard, layer 0
    drawing the sky with its pre-pass unless the texture instance draws it,
    no plain call."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    return (n * len(configs), n * int(sky), n * int(sky and not mk.texture_mode(configs[0])), 0)


def shard_frames(inputs, scene, cam, h: int, w: int, n: int, plain: bool = False) -> dict:
    """n shards of a frame through the band entries (``plain``: their plain
    version) put together: ``{"color", "alpha"}``."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    params, configs, tex, pdata, pmeta = inputs
    fn = mk.render_scene_band_plain if plain else mk.render_scene_band_megakernel
    rows = h // n
    outs = [fn(params, configs, cam, scene.opaque, h, w, s * rows, rows, tex_data=tex,
               pano_data=pdata, pano_meta=pmeta) for s in range(n)]
    return {k: torch.cat([o[k] for o in outs]) for k in ("color", "alpha")}


def check_shards(label: str, scene, cam, h: int, w: int, n: int, device) -> dict:
    """n shards of a frame through the band entries: the counters; each
    shard against its plain version on the same CUDA inputs (cloud
    tolerance); the pre-pass of each procedural sky shard against its plain
    version (the same choice in every tile); the assembled frame against
    ``Scene.render`` of the same frame (cloud tolerance).  Returns the
    largest |Δ| against plain and the statistics against ``Scene.render``."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
    from godot_atmosphere_shader_tpu_torch.ops.kernels import texsample as ts

    inputs = shard_inputs(scene, cam)
    params, configs, tex, pdata, pmeta = inputs
    rows = h // n
    mk.counters.reset()
    ts.counters.reset()
    got = shard_frames(inputs, scene, cam, h, w, n)
    torch.cuda.synchronize()
    counts = band_counts()
    want = expected_band_counts(configs, n, pdata is not None)
    worst = 0.0
    for s in range(n):
        part = {k: v[s * rows:(s + 1) * rows] for k, v in got.items()}
        ref = mk.render_scene_band_plain(params, configs, cam, scene.opaque, h, w, s * rows,
                                         rows, tex_data=tex, pano_data=pdata, pano_meta=pmeta)
        st = cloud_deltas(frame_array(part), frame_array(ref))
        log(f"[shard] {label} {h}x{w} shard {s}/{n} kernel vs plain: {json.dumps(st)}")
        if not cloud_tolerance_ok(st):
            raise RuntimeError(f"{label}: shard {s} disagrees with its plain version")
        worst = max(worst, st["max"])
        if pdata is not None and not mk.texture_mode(configs[0]):
            _, struct, args = mk.band_launches(params, configs, cam, scene.opaque, h, w,
                                               s * rows, rows, tex_data=tex, pano_data=pdata,
                                               pano_meta=pmeta)[0]
            choice = mk.sky_choices(struct, args["sky"][0], device).cpu()
            ref_choice = mk.sky_choices_plain(cam, h, w, pmeta, row0=s * rows, rows=rows).cpu()
            if not torch.equal(choice, ref_choice):
                raise RuntimeError(f"{label}: the sky's pre-pass on shard {s} disagrees with "
                                   "its plain version")
    img = frame_array(got)
    check_frame(img, f"{label} shards")
    st = cloud_deltas(img, frame_array(scene.render(cam, h, w)))
    log(f"[shard] {label} {h}x{w} on {n} shards: counters K1 {counts[0]}, sky {counts[1]}, "
        f"sky pre-pass {counts[2]}, plain {counts[3]} (planned {want}); assembled vs "
        f"Scene.render: {json.dumps(st)}")
    if counts != want:
        raise RuntimeError(f"{label}: the shards did not go through the planned K1 launches")
    if not cloud_tolerance_ok(st):
        raise RuntimeError(f"{label}: the assembled shards disagree with Scene.render")
    return {"vs_plain_max": worst, "vs_scene_render": st}


def sharded_flight(scene, cam, stack, h: int, w: int, mesh, t0: float = 0.5) -> dict:
    """``Scene.render_flight`` with TAA over ``mesh``, the flight's counters
    reset just before and read just after: ``(out, (K1, K3, plain))``."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
    from godot_atmosphere_shader_tpu_torch.ops.kernels import taa

    mk.counters.reset()
    taa.counters.reset()
    out = scene.render_flight(cam, flight_times(len(stack), t0), h, w, cam_transforms=stack,
                              taa_blend=FLIGHT_BLEND, mesh=mesh)
    torch.cuda.synchronize()
    return out, (mk.counters.megakernel_launches, taa.counters.launches,
                 mk.counters.plain_calls + taa.counters.plain_calls)


def band_timing(scene, cam, h: int, w: int, n: int, device) -> dict:
    """Each K1 launch of n shards of a frame timed alone (CUDA events) with
    its roofline bound from its work counters; all of them in sequence (the
    sharded frame's kernel ms); the plain band chain of every shard."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    inputs = shard_inputs(scene, cam)
    params, configs, tex, pdata, pmeta = inputs
    rows = h // n
    shards, out, bound = [], [], 0.0
    for s in range(n):
        launches = mk.band_launches(params, configs, cam, scene.opaque, h, w, s * rows, rows,
                                    tex_data=tex, pano_data=pdata, pano_meta=pmeta)
        planes = (torch.empty((rows, w, 3), device=device), torch.empty((rows, w), device=device),
                  torch.empty((rows, w), device=device))
        for _, struct, args in launches:  # the planes the chained launches read
            mk.launch(struct, planes[0], planes[1], depth=planes[2], **args)
        for layer, (_, struct, args) in enumerate(launches):
            ms = time_cuda(lambda i, st=struct, a=args, p=planes: mk.launch(
                st, p[0], p[1], depth=p[2], **a), KERNEL_FRAMES)
            work = mk.work_counts(struct, planes[0], planes[1], depth=planes[2], **args)
            cost = (sky_cost(cam, h, w, pmeta, in_block=args["tex"] is not None, row0=s * rows,
                             rows=rows) if struct.with_sky else {})
            tl = args["tex"]
            table_bytes = 0 if tl is None else sum(x.numel() * 4 for x in tl[1:])
            per_px = BYTES_CHAINED_PIXEL if struct.with_background else BYTES_BAND_PIXEL
            b = roofline(work, configs[layer], h, w, table_bytes, frame_bytes=rows * w * per_px,
                         sky_bytes=cost.get("sky_bytes", 0),
                         sky_choice_ops=cost.get("sky_choice_ops", 0))
            bound += b["bound_ms"]
            out.append({"shard": s, "layer": layer, "row0": struct.row0, "rows": rows,
                        "sky": bool(struct.with_sky), "texture": tl is not None, "ms": ms, **b,
                        "sky_levels": cost.get("sky_levels"), "work": work})
        shards.append((launches, planes))

    def frame(i):
        for launches, p in shards:
            for _, st, a in launches:
                mk.launch(st, p[0], p[1], depth=p[2], **a)

    return {"launches": out, "frame_kernel_ms": time_cuda(frame, KERNEL_FRAMES),
            "frame_bound_ms": bound,
            "plain_ms": time_cuda(lambda i: shard_frames(inputs, scene, cam, h, w, n, plain=True),
                                  1, warmup=0)}


def taa_band_check(device, h: int, w: int, n: int, halo: int) -> dict:
    """K3 alone on n shards of an h × w frame, each against a history band
    of its rows and ``halo`` rows above and below (zeros past the frame's
    edges), on the partial-tile case: each shard against its plain
    version and the shards put together against the full-frame K3, bit for
    bit; each shard's launch timed (CUDA events, and its device time from a
    ``torch.profiler`` trace) beside its plain version and its bound (48 B and ~300 operations per pixel, plus the halo rows'
    color and depth read once).  The case keeps every reprojection within
    the halo and off the frame's last row (where the whole frame's window,
    clamped at the frame's edge, cannot reach and a shard's zero halo can):
    only then are the two bit-equal, in the JAX package as here."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import taa
    from godot_atmosphere_shader_tpu_torch.utils.camera import Camera

    case = next(c for c in TAA_CASES if c[0] == "partial_tile")
    _, prev, cur, blend, opt = case
    color, ld, hist, hd = taa_case_inputs(case, h, w, device)
    cams = (Camera.create(prev, device="cpu"), Camera.create(cur, device="cpu"))
    full, full_depth = torch.empty_like(color), torch.empty_like(ld)
    taa.launch(taa.taa_constants(*cams, blend, h, w, h), color, ld, hist, hd, full, full_depth)

    def pad(t):
        z = torch.zeros((halo,) + tuple(t.shape[1:]), device=device)
        return torch.cat([z, t, z])

    hp, dp = pad(hist), pad(hd)
    rows = h // n
    bands, err, exact, ms, device_ms, plain_ms = [], 0.0, True, [], [], []
    for s in range(n):
        r0 = s * rows
        p = taa.taa_constants(*cams, blend, h, w, rows + 2 * halo, rows=rows, row0=r0,
                              hist_row0=r0 - halo)
        args = (color[r0:r0 + rows], ld[r0:r0 + rows], hp[r0:r0 + rows + 2 * halo],
                dp[r0:r0 + rows + 2 * halo])
        out, depth = torch.empty_like(args[0]), torch.empty_like(args[1])
        valid = torch.empty((rows, w), dtype=torch.uint8, device=device)
        taa.launch(p, *args, out, depth, valid)
        ref, ref_depth, ref_valid = taa.resolve_plain(p, *args)
        torch.cuda.synchronize()
        err = max(err, float((out - ref).abs().max()))
        exact = exact and bool(torch.equal(out, ref) and torch.equal(depth, ref_depth)
                               and torch.equal(valid.bool(), ref_valid))
        bands.append(out)
        ms.append(time_cuda(lambda i, p=p, a=args, o=out, d=depth: taa.launch(p, *a, o, d),
                            KERNEL_FRAMES))
        device_ms.append(kernel_trace(lambda p=p, a=args, o=out, d=depth: [
            taa.launch(p, *a, o, d) for _ in range(KERNEL_FRAMES)], "taa_kernel")["device_us"] / 1e3)
        plain_ms.append(time_cuda(lambda i, p=p, a=args: taa.resolve_plain(p, *a), 3))
    reassembled = bool(torch.equal(torch.cat(bands), full))
    t_bytes = (rows * w * BYTES_TAA_PIXEL + 2 * halo * w * 16) / PEAK_BYTES * 1e3
    t_ops = ops_time_ms(rows * w * OPS_TAA_PIXEL)
    t = {"shards": n, "rows": rows, "halo": halo, "max_abs_err": err,
         "equal_to_plain": exact, "reassembled_equal_to_full": reassembled,
         "ms_per_shard": ms, "ms": sum(ms) / n, "device_ms_per_shard": device_ms,
         "device_ms": sum(device_ms) / n, "plain_ms": sum(plain_ms) / n,
         "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if not (exact and reassembled):
        raise RuntimeError("K3's band mode is not bit-equal to its plain version and to the "
                           "full-frame launch")
    return t


@contextlib.contextmanager
def nccl_world_of_one_mesh(device):
    """The distributed mesh of one rank on NCCL (file rendezvous under
    ``build/``); a failed initialisation raises."""
    import torch.distributed as dist

    from godot_atmosphere_shader_tpu_torch.parallel.sharding import make_mesh

    rendezvous = os.path.join(ROOT, "build", "chip_smoke_rendezvous")
    os.makedirs(os.path.dirname(rendezvous), exist_ok=True)
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}", world_size=1, rank=0)
    try:
        yield make_mesh(group=dist.group.WORLD)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()


def nccl_world_of_one(device, frame, flight) -> dict:
    """The distributed mesh of one rank on NCCL against the local mesh of
    one shard: ``frame(mesh)`` and ``flight(mesh)`` must be equal bit for
    bit."""
    import torch.distributed as dist

    from godot_atmosphere_shader_tpu_torch.parallel.sharding import make_mesh

    with nccl_world_of_one_mesh(device) as mesh:
        got = (frame(mesh), flight(mesh))
        backend = dist.get_backend()
    local = (frame(make_mesh(1)), flight(make_mesh(1)))
    same = {name: all(bool(torch.equal(a[k], b[k])) for k in ("color", "alpha"))
            for name, a, b in zip(("frame", "flight"), got, local)}
    if not all(same.values()):
        raise RuntimeError(f"NCCL world size 1 differs from the local mesh of one shard: {same}")
    return {"backend": backend, "mesh_size": mesh.size, "bit_equal": same}


# -- K1 slice (h): the procedural envelope ----------------------------------------


def envelope_config(name: str):
    """A config of K1's procedural envelope on the demo scene, from the
    flagship ``clouds_high`` (``dataclasses.replace``, as the users' own
    configs are built): the four frames of phase 4f (:data:`ENVELOPE_FRAMES`)
    and the small cases of phase 3g (:func:`envelope_cases`)."""
    from godot_atmosphere_shader_tpu_torch.models import demo
    from godot_atmosphere_shader_tpu_torch.models.params import VARIANTS, ProceduralField

    flagship = demo.demo_variant("clouds_high")
    if name == "cellular_tier":  # render --shape-basis cellular
        return demo.demo_variant("clouds_high", shape_basis="cellular")
    if name == "reference_profile":  # the reference shader: every field per step
        return dataclasses.replace(flagship, cloud_coverage_interp=False, cloud_coverage_lod=1,
                                   cloud_lod=1, cloud_lod_interior=0, knot_dynamic=False)
    if name == "tscn_profile":  # what models/tscn.py:503-512 builds from the demo's .tscn
        return dataclasses.replace(
            VARIANTS["clouds"],
            cloud_shape_noise=ProceduralField(noise=demo.SHAPE_NOISE_BAKE,
                                              scale=(float(demo.SHAPE_TEXTURE_SIZE),) * 3),
            cloud_coverage_noise=ProceduralField(noise=demo.COVERAGE_NOISE,
                                                 scale=demo.COVERAGE_SCALE),
            cloud_coverage_interp=True)
    if name == "full_quality":  # the detail field per step
        return dataclasses.replace(flagship, clouds_always_low_quality=False)
    if name in KNOT_GROUP_CASES:
        return dataclasses.replace(flagship, **KNOT_GROUP_CASES[name])
    return envelope_cases()[name]


def envelope_cases() -> dict:
    """Phase 3g's small cases beyond the four frames: each basis as the
    shape and as the coverage (cellular with its three returns), the
    ping-pong fractal, weighted_strength under fbm, ridged and ping-pong,
    coverage K = 4 and 16, procedural shape knots K_s = 8, 16, 32, full
    quality with shape and detail knots under cheap and raymarched light,
    LOD groups of 16 and 32 rows, and hat-sum knots on the demo profile."""
    from godot_atmosphere_shader_tpu_torch.models import demo

    flagship = demo.demo_variant("clouds_high")
    shape, cov = flagship.cloud_shape_noise, flagship.cloud_coverage_noise

    def field(f, **kw):
        return dataclasses.replace(f, noise=dataclasses.replace(f.noise, **kw))

    cases = {}
    for basis, ret in (("perlin", "distance"), ("simplex", "distance"), ("cellular", "distance"),
                       ("cellular", "distance2"), ("cellular", "cell_value"),
                       ("cellular_fast", "distance")):
        label = basis if basis != "cellular" else f"cellular_{ret}"
        cases[f"shape_{label}"] = dict(cloud_shape_noise=field(shape, noise_type=basis,
                                                               cellular_return=ret))
        cases[f"coverage_{label}"] = dict(cloud_coverage_noise=field(cov, noise_type=basis,
                                                                     cellular_return=ret))
    cases["shape_ping_pong"] = dict(cloud_shape_noise=field(shape, fractal_type="ping_pong"))
    cases["coverage_fbm_weighted"] = dict(cloud_coverage_noise=field(cov, weighted_strength=0.5))
    cases["shape_ridged_weighted"] = dict(cloud_shape_noise=field(shape, weighted_strength=0.5))
    cases["shape_ping_pong_weighted"] = dict(cloud_shape_noise=field(
        shape, fractal_type="ping_pong", weighted_strength=0.5))
    for k in (4, 16):
        cases[f"coverage_k{k}"] = dict(cloud_coverage_knots=k)
    for k in (8, 16, 32):
        cases[f"shape_knots_{k}"] = dict(cloud_shape_interp=True, cloud_shape_knots=k)
    cases["detail_knots_cheap"] = dict(cloud_shape_interp=True, clouds_always_low_quality=False)
    cases["detail_knots_raymarched"] = dict(cloud_shape_interp=True,
                                            clouds_always_low_quality=False,
                                            raymarched_lighting=True)
    cases["group_16"] = dict(cloud_lod=8, cloud_coverage_lod=2, cloud_lod_interior=0)
    cases["group_32"] = dict(cloud_lod=16, cloud_coverage_lod=2, cloud_lod_interior=0)
    cases["hat_sum_knots"] = dict(knot_dynamic=False)
    return {k: dataclasses.replace(flagship, **v) for k, v in cases.items()}


def envelope_scene(name: str, device, pose: str = "avatar", t: float = 0.5):
    """The demo scene with an envelope config on its planet, updated."""
    from godot_atmosphere_shader_tpu_torch.models.demo import build_demo_scene, demo_camera

    scene = build_demo_scene("clouds_high", device=device)
    scene.atmospheres[0].set_custom_shader(envelope_config(name))
    cam = demo_camera(pose, device=device)
    scene.update(t, cam)
    return scene, cam


def full_quality(scene, cam) -> bool:
    _, _, configs = scene._sorted_layers(cam)
    return not configs[0].clouds_always_low_quality


def detail_conditioning(device, h: int, w: int) -> dict:
    """How far one ulp of the camera's position moves a frame: the plain
    frame against itself with the camera one ulp further along z, at full
    quality (the detail field) and at low quality, on the card."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    out = {}
    for name in ("full_quality", "hat_sum_knots"):
        scene, cam = envelope_scene(name, device)
        inputs, _ = frame_inputs(scene, cam)
        a = frame_array(mk.render_frame_plain(*inputs, h, w))
        v2w = cam.view_to_world.clone()
        v2w[2, 3] = torch.nextafter(v2w[2, 3], torch.tensor(1e9, device=device))
        cam2 = dataclasses.replace(cam, view_to_world=v2w)
        scene.update(0.5, cam2)
        inputs2, _ = frame_inputs(scene, cam2)
        b = frame_array(mk.render_frame_plain(*inputs2, h, w))
        out["full quality" if name == "full_quality" else "low quality"] = cloud_deltas(a, b)
    return out


@contextlib.contextmanager
def spans_one_ulp_longer():
    """Inside the block the plain renderer marches every coarse pixel's
    span to one ulp past its clamped end (``ops/clouds.py``
    ``clamp_march_distance``)."""
    from godot_atmosphere_shader_tpu_torch.ops import clouds

    clamp = clouds.clamp_march_distance

    def longer(*args):
        t_end = clamp(*args)
        return torch.nextafter(t_end, torch.full_like(t_end, float("inf")))

    clouds.clamp_march_distance = longer
    try:
        yield
    finally:
        clouds.clamp_march_distance = clamp


def span_conditioning(device, h: int, w: int) -> dict:
    """How far one ulp of the march spans moves a frame: the plain frame
    against itself with every span one ulp longer, on the card, for the
    knot-group cases and the demo profile with 16 shape knots (a coverage
    group of 4 rows)."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    out = {}
    for name in (*KNOT_GROUP_CASES, "shape_knots_16"):
        scene, cam = envelope_scene(name, device)
        inputs, _ = frame_inputs(scene, cam)
        a = frame_array(mk.render_frame_plain(*inputs, h, w))
        with spans_one_ulp_longer():
            b = frame_array(mk.render_frame_plain(*inputs, h, w))
        out[name] = cloud_deltas(a, b)
    return out


def knot_group_check(device, h: int, w: int, span: dict) -> dict:
    """The knot-group cases at ``h × w`` through ``Scene.render`` (one
    launch of the procedural instance, no plain call) against the plain
    chain: under the cloud tolerance, or under
    :func:`knot_group_tolerance_ok` where ``span`` (:func:`span_conditioning`
    at the same size) shows the plain frame leaving the cloud tolerance
    with every march span one ulp longer."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    out = {}
    for name in KNOT_GROUP_CASES:
        ill = not cloud_tolerance_ok(span[name])
        scene, cam = envelope_scene(name, device)
        err, _ = check_scene(f"knot group {name}", scene, cam, h, w,
                             knot_group_tolerance_ok if ill else cloud_tolerance_ok)
        if mk.counters.general_launches != 1:
            raise RuntimeError(f"knot group {name}: not rendered by the procedural instance")
        out[name] = {"max": err, "tolerance": "knot group" if ill else "cloud"}
    return out


def envelope_check(device, h: int, w: int) -> dict:
    """Phase 3g: every small envelope case (:func:`envelope_cases`; the
    four frames are phase 4f's) at ``h × w`` through ``Scene.render``
    (one K1 launch of the procedural instance, no plain call), held against
    the plain chain on the same inputs: the cloud tolerance, the detail
    tolerance at full quality.  Returns the statistics per case."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    out = {}
    for name in envelope_cases():
        scene, cam = envelope_scene(name, device)
        _, _, configs = scene._sorted_layers(cam)
        mk.check_config(configs[0])
        err, _ = check_scene(f"envelope {name}", scene, cam, h, w,
                             detail_tolerance_ok if full_quality(scene, cam)
                             else cloud_tolerance_ok)
        # check_scene sets the counters to 0 before its frame
        if mk.counters.general_launches != 1:
            raise RuntimeError(f"envelope {name}: not rendered by the procedural instance")
        out[name] = {"max": err}
    # a partial last LOD group: 16-row groups over h - 8 rows
    scene, cam = envelope_scene("group_16", device)
    err, _ = check_scene(f"envelope group_16, {h - 8} rows", scene, cam, h - 8, w)
    out["group_16_partial"] = {"max": err}
    return out


def check_envelope_frame(label: str, scene, cam, img: np.ndarray, h: int, w: int) -> dict:
    """Phase 4f's check of one kernel frame against the whole plain frame on
    the same inputs (its wall time kept as the plain ms); detail or cloud
    tolerance as in 3g."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    ok = detail_tolerance_ok if full_quality(scene, cam) else cloud_tolerance_ok
    torch.cuda.synchronize()
    t0 = time.time()
    ref = frame_array(mk.render_frame_plain(*frame_inputs(scene, cam)[0], h, w))
    res = {"plain_s": time.time() - t0}
    st = cloud_deltas(img, ref)
    res.update(st)
    log(f"[envelope] {label} {h}x{w} kernel vs the whole plain frame: {json.dumps(res)}")
    if not ok(st):
        raise RuntimeError(f"{label}: the 1080p kernel frame disagrees with plain")
    return res


def envelope_timing(scene, cam, h: int, w: int, device, check: dict) -> dict:
    """Phase 5e for one frame: the kernel launch alone (CUDA events) with
    its bound from its work counters under the measured peak,
    ``Scene.render`` ms and idle share, and the plain ms that phase 4f's
    ``check`` took (wall time to the whole plain frame on the host)."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    inputs, _ = frame_inputs(scene, cam)
    struct = mk.frame_constants(*inputs, h, w)
    color = torch.empty((h, w, 3), device=device)
    alpha = torch.empty((h, w), device=device)
    base = 0.5

    def frame(i):
        scene.update(base + 0.05 * i, cam)
        scene.render(cam, h, w)

    t = {"kernel_ms": time_cuda(lambda i: mk.launch(struct, color, alpha), ENVELOPE_KERNEL_FRAMES),
         "scene_ms": time_cuda(frame, ENVELOPE_KERNEL_FRAMES)}
    busy, kernel = device_busy_ms(frame, ENVELOPE_KERNEL_FRAMES, first=2 + ENVELOPE_KERNEL_FRAMES)
    t["scene_device_busy_ms"] = busy
    t["scene_megakernel_device_ms"] = kernel
    t["scene_idle_share"] = 1.0 - busy / t["scene_ms"] if busy > 0 else None
    scene.update(base, cam)
    work = mk.work_counts(struct, color, alpha)
    t.update(roofline(work, inputs[1], h, w), work=work)
    t["plain_ms"] = check["plain_s"] * 1e3
    return t


# -- the procedural instance per stage --------------------------------------------

# The work counts of the procedural kernel before its redesign for Hopper (a
# thread per column and coverage group marching its own coarse pixels, two
# opaque passes per pixel) on phase 5f's 1080p frames, per launch of the
# procedural instance, as an H100 counted them (compare_megakernel.py): the
# redesign must count the same work, so every bound stays.
PARENT_WORK_KEYS = ("march", "knot_groups", "coverage_evals", "shape_evals", "detail_evals",
                    "sun_samples")
PARENT_WORK = {
    "clouds_high/avatar": [(666955, 333738, 0, 42685120, 0, 0)],
    "clouds_high/interior": [(518400, 259200, 0, 33177600, 0, 0)],
    "clouds/avatar": [(666955, 333738, 0, 21342560, 0, 0)],
    "clouds_high/avatar with the sky": [(666955, 333738, 0, 42685120, 0, 0)],
    "clouds_high/sunward with the sky": [(20798, 10524, 0, 1331072, 0, 0)],
    "cell 5": [(53987, 27226, 0, 24186176, 0, 20731008)],
    "clouds_high/avatar on 2 shards": [(333310, 166784, 0, 21331840, 0, 0),
                                       (333645, 166954, 0, 21353280, 0, 0)],
    "cellular_tier": [(666955, 333738, 0, 42685120, 0, 0)],
    "reference_profile": [(1333922, 0, 85371008, 85371008, 0, 0)],
    "tscn_profile": [(1333922, 1333922, 0, 42685504, 0, 0)],
    "full_quality": [(666960, 333738, 0, 42685440, 42685440, 0)],
}


# The texture instance's work counts before its registers were sized for
# two tiles per SM at G = 8, on phase 5f's texture frames, per texture
# launch (the 4 shards' chained planet layers of phase 4e in shard order), as
# an H100 counted them (compare_megakernel.py).
PARENT_TEX_WORK_KEYS = ("pixels", "atmosphere", "knot_groups", "march", "tex3d", "tex3d_floor",
                        "latlong", "latlong_floor", "sky", "sky_floor")
PARENT_TEX_WORK = {
    "clouds_high texture/avatar": [(2073600, 1432644, 366592, 670432, 0, 6232064, 3299328, 0, 0,
                                    0)],
    "clouds_high texture/interior": [(2073600, 2073600, 261120, 522240, 1022976, 3416064,
                                      2350080, 0, 0, 0)],
    "everything-on/avatar with the sky": [(2073600, 1432644, 366592, 670432, 0, 6232064,
                                           3299328, 0, 827055, 0)],
    "everything-on/avatar 1024x1920 on 4 shards": [
        (491520, 294812, 79872, 135342, 0, 1357824, 718848, 0, 0, 0),
        (491520, 349132, 90112, 164292, 0, 1531904, 811008, 0, 0, 0),
        (491520, 349132, 90112, 164590, 0, 1531904, 811008, 0, 0, 0),
        (491520, 294812, 79872, 135342, 0, 1357824, 718848, 0, 0, 0)],
}


# The general texture instance's work counts before its redesign (one
# 512-thread block per tile, PR 11's), on phase 4g's frames and bench cell 6
# asked of it, per launch, as an H100 counted them (chip_smoke.py phase 5f
# on the parent's kernels): every slot but the march's lanes, which that
# design did not count.
PARENT_TEXG_WORK_KEYS = ("pixels", "atmosphere", "knot_groups", "march", "tex3d", "tex3d_floor",
                         "latlong", "latlong_floor", "sun_samples", "sky", "sky_floor",
                         "coverage_evals", "shape_evals", "detail_evals", "shape_knots",
                         "detail_knots", "od_segments")
PARENT_TEXG_WORK = {
    "texture reference profile": [(2073600, 1432644, 1333922, 1333922, 0, 22676674, 12005298, 0,
                                   0, 0, 0, 0, 0, 0, 0, 0, 10606680)],
    "texture full quality": [(2073600, 1432644, 333738, 666960, 0, 11347092, 3003642, 0, 0, 0,
                              0, 0, 0, 0, 0, 0, 10606680)],
    "shape baked, coverage procedural": [(2073600, 1432644, 333738, 666955, 0, 5673546, 0, 0, 0,
                                          0, 0, 0, 0, 0, 0, 0, 10606680)],
    "shape procedural, coverage baked": [(2073600, 1432644, 333738, 666960, 0, 0, 3003642, 0, 0,
                                          0, 0, 0, 42685440, 0, 0, 0, 10606680)],
    "bench cell 6 through the general instance": [(2073600, 1432644, 333738, 666960, 0, 5673546,
                                                   3003642, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                                   10606680)],
}


def check_parent_work(label: str, works: list):
    """Each cloud launch's work counts against the previous design's."""
    if label in PARENT_TEXG_WORK:
        keys, parent = PARENT_TEXG_WORK_KEYS, PARENT_TEXG_WORK
    elif label in PARENT_TEX_WORK:
        keys, parent = PARENT_TEX_WORK_KEYS, PARENT_TEX_WORK
    elif label in PARENT_WORK:
        keys, parent = PARENT_WORK_KEYS, PARENT_WORK
    else:
        raise RuntimeError(f"{label}: no work counts of the previous design to hold it to")
    got = [tuple(w[k] for k in keys) for w in works]
    if got != parent[label]:
        raise RuntimeError(f"{label}: work counts {got} differ from the previous design's "
                           f"{parent[label]} ({keys})")


def lane_utilisation(work: dict):
    """The march's lane utilisation: lane-steps over 32 × warp-steps."""
    warp = work["march_warp_steps"]
    return work["march_lane_steps"] / (32.0 * warp) if warp else None


def gen_instances(struct) -> dict:
    """What each instance of the procedural kernel uses on this card
    (``mk.gen_info``) for ``struct`` with C coarse pixels per thread, each C
    the launcher takes, at L = min(cloud_lod, 32 / C) rows per coarse pixel."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    out = {}
    for c in mk.GEN_COARSE:
        st = mk.MegakernelParams.from_buffer_copy(struct)
        st.coverage_lod, st.cloud_lod = c, min(struct.cloud_lod, TILE // c)
        out[f"C={c} L={st.cloud_lod}"] = mk.gen_info(st)
    return out


def stage_split(plan, scene, cam, h: int, w: int, device, measure_path: str,
                general: bool = False) -> list:
    """Phase 5f for one frame: each cloud launch (the procedural or the
    texture instance; ``general``: the general texture instance, as
    ``mk.launch`` takes it) in the frame's plan with what its instance uses
    (``mk.gen_info``, ``mk.tex_info``), the march's lane utilisation
    (normal build; the procedural instance) and its cycles per stage,
    summed over warps (the measurement build, whose work counts must equal
    the normal build's); the other launches run once for the planes they
    write."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    params, configs, tex, bands, rows = plan
    pano_data, pano_meta = scene._pano_plan() or (None, None)
    launches = mk.scene_launches(params, configs, cam, scene.opaque, h, w, tex_data=tex,
                                 bands=bands, band_rows=rows, pano_data=pano_data,
                                 pano_meta=pano_meta)
    color = torch.empty((h, w, 3), device=device)
    alpha = torch.empty((h, w), device=device)
    depth = torch.empty((h, w), device=device)
    out = []
    for kind, struct, args in launches:
        if not (struct.clouds_enabled and struct.with_atmosphere):
            mk.launch(struct, color, alpha, depth=depth, **args)
            continue
        work = mk.work_counts(struct, color, alpha, depth=depth, general=general, **args)
        with mk.use_library(measure_path):
            measured = mk.work_counts(struct, color, alpha, depth=depth, stages=True,
                                      general=general, **args)
        if any(measured[k] != work[k] for k in mk.WORK_SLOTS):
            raise RuntimeError(f"the measurement build's work counts differ: {measured} {work}")
        cycles = {k: measured[f"stage_{k}_cycles"] for k in mk.STAGE_SLOTS}
        total = sum(cycles.values())
        info = (mk.gen_info(struct) if args["tex"] is None
                else mk.tex_info(struct, args["tex"][0], general))
        out.append({"kind": kind, "row0": struct.row0, "rows": struct.rows,
                    "instance": ("gen" if args["tex"] is None
                                 else "tex_general" if info["general"] else "tex"),
                    **info, "work": work,
                    "lane_utilisation": lane_utilisation(work), "stage_cycles": cycles,
                    "stage_share": {k: v / total for k, v in cycles.items()} if total else None})
    return out


# -- T2: the card's arithmetic ceilings ---------------------------------------------


def peak_probe(device) -> dict:
    """T2 (``probes.peak_chains``): each chain op against its plain version
    at PEAK_CHECK_ITERS on 8 blocks, then timed with CUDA events at
    PEAK_ITERS on SMs × PEAK_BLOCKS_PER_SM blocks (best of PEAK_REPS
    launches after one warm-up), every timed launch's output held against
    the plain chains at the same iteration count (PEAK_TOL; the plain run
    is timed: its ms), with the clocks, power and limit sampled by
    ``nvidia-smi`` while fma launches run.  Rates: fp32 FLOP/s (an FMA is
    2), exp/s, __expf/s, INT32 IMAD instructions/s; the ceilings at the
    sampled SM clock (SMs × 128 lanes × 2, SMs × 64 lanes) and the spec
    values beside them."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import probes

    g = np.random.default_rng(3)
    a = torch.as_tensor((g.random(probes.PEAK_PLANE) * 0.5 + 0.25).astype(np.float32),
                        device=device)
    b = torch.as_tensor((g.random(probes.PEAK_PLANE) * 0.1).astype(np.float32), device=device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = sms * PEAK_BLOCKS_PER_SM
    threads = blocks * probes.PEAK_THREADS
    probes.counters.reset()
    out = {"sms": sms, "blocks": blocks, "threads": threads, "check": {}, "timed_check": {},
           "ms": {}, "plain_ms": {}}

    def err_of(got, ref):
        return float((got.reshape(-1, probes.PEAK_PLANE) - ref).abs().max())

    for op in probes.PEAK_OPS:
        err = err_of(probes.peak_chains(a, b, op, PEAK_CHECK_ITERS, 8),
                     probes.chains_plain(a, b, op, PEAK_CHECK_ITERS))
        out["check"][op] = err
        if not err <= PEAK_TOL[op]:
            raise RuntimeError(f"the peak probe's {op} chains disagree with plain: {err}")
    rates = {}
    for op, iters in PEAK_ITERS.items():
        outs, times = [], []
        for _ in range(1 + PEAK_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            outs.append(probes.peak_chains(a, b, op, iters, blocks))
            end.record()
            times.append((start, end))
        torch.cuda.synchronize()
        ms = min(s.elapsed_time(e) for s, e in times[1:])
        t0 = time.time()
        ref = probes.chains_plain(a, b, op, iters)
        torch.cuda.synchronize()
        out["plain_ms"][op] = (time.time() - t0) * 1e3
        err = max(err_of(o, ref) for o in outs)
        out["timed_check"][op] = err
        if not err <= PEAK_TOL[op]:
            raise RuntimeError(f"a timed {op} launch disagrees with the plain chains: {err}")
        out["ms"][op] = ms
        steps = probes.PEAK_CHAINS * probes.PEAK_INNER[op] * iters
        rates[op] = threads * steps / (ms * 1e-3)
    for _ in range(24):  # ~0.8 s of fma in flight while nvidia-smi samples
        probes.peak_chains(a, b, "fma", PEAK_ITERS["fma"], blocks)
    out["clocks_under_load"] = smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    torch.cuda.synchronize()
    hz = float(out["clocks_under_load"].split()[0]) * 1e6
    out.update(fp32_flops=2.0 * rates["fma"], exp_per_s=rates["exp"],
               fast_exp_per_s=rates["fast_exp"], int32_per_s=rates["imad"],
               clock_fp32_flops=sms * 128 * 2 * hz, clock_int32_per_s=sms * 64 * hz,
               spec_fp32_flops=SPEC_FP32, spec_int32_per_s=SPEC_INT32,
               fp32_spec_ratio=2.0 * rates["fma"] / SPEC_FP32,
               int32_spec_ratio=rates["imad"] / SPEC_INT32,
               launches=probes.counters.peak_launches,
               max_abs_err=max(max(out["check"].values()), max(out["timed_check"].values())))
    out.update(fp32_clock_ratio=out["fp32_flops"] / out["clock_fp32_flops"],
               int32_clock_ratio=out["int32_per_s"] / out["clock_int32_per_s"])
    return out


# -- phase 8: the CLI and the scene importer, K1 sized per scene, large worlds,
# the optical-depth LUT ------------------------------------------------------------


def camera_moves(cam) -> tuple:
    """The ULP_MOVES along the camera position's nonzero coordinates: one
    ulp of a zero coordinate is a denormal, which moves no frame."""
    return tuple((a, s) for a, s in ULP_MOVES if float(cam.view_to_world[a, 3]) != 0.0)


def tight_deltas(got: np.ndarray, ref: np.ndarray) -> dict:
    """A cloud-free frame against its reference at atol 1e-5, rtol 1e-4:
    the largest |Δ| and the share of values beyond the bound."""
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    over = d > 1e-5 + 1e-4 * np.abs(ref.astype(np.float64))
    return {"max": float(d.max()), "over": float(over.mean())}


def ulp_move(scene, cam, h: int, w: int, renderer: str = "plain", t: float = 0.5,
             moves=ULP_MOVES, base=None) -> dict:
    """The largest move (by mean |Δ|) of the scene's frame (``renderer``'s)
    when the camera's position moves one ulp of a coordinate (``moves``:
    axis and sign pairs), the scene updated at ``t``; ``base``: the frame
    at ``cam``, where the caller has rendered it already."""
    scene.update(t, cam)
    if base is None:
        base = frame_array(scene.render(cam, h, w, renderer=renderer))
    worst = None
    for axis, sign in moves:
        v2w = cam.view_to_world.clone()
        v2w[axis, 3] = torch.nextafter(v2w[axis, 3],
                                       torch.tensor(sign * 1e9, device=v2w.device))
        moved = dataclasses.replace(cam, view_to_world=v2w)
        scene.update(t, moved)
        st = cloud_deltas(frame_array(scene.render(moved, h, w, renderer=renderer)), base)
        if worst is None or st["mean"] > worst["mean"]:
            worst = st
    scene.update(t, cam)
    return worst


def geometry_conditioning(device) -> dict:
    """Phase 3j's measurement first: with the demo's octave chains, one ulp
    of the camera moves the plain frame of the procedural 10-octave case
    (16 spheres, 12 boxes) beyond the cloud tolerance, as far as kernel and
    plain could lie apart; with GEOMETRY_CHAINS it moves it within, while
    the same case with two octaves fewer fails it (the octaves past the
    struct's weigh in the frame).  Raises where the latter two fail."""
    h, w = GEOMETRY_SIZE
    case = (16, 12, 10)
    demo, _ = crowded_scene("procedural", *case, device, chains={})
    scene, cam = crowded_scene("procedural", *case, device)
    fewer, fcam = crowded_scene("procedural", case[0], case[1], case[2] - 2, device)
    out = {"demo_chains_ulp": ulp_move(demo, cam, h, w), "ulp": ulp_move(scene, cam, h, w),
           "two_octaves_fewer": cloud_deltas(
               frame_array(fewer.render(fcam, h, w, renderer="plain")),
               frame_array(scene.render(cam, h, w, renderer="plain")))}
    log(f"[geometry] one ulp of the camera moves the plain {h}x{w} frame of {case} with the "
        f"demo's octave chains by {json.dumps(out['demo_chains_ulp'])}, with "
        f"{GEOMETRY_CHAINS} by {json.dumps(out['ulp'])}; two octaves fewer move it by "
        f"{json.dumps(out['two_octaves_fewer'])}")
    if not cloud_tolerance_ok(out["ulp"]) or cloud_tolerance_ok(out["two_octaves_fewer"]):
        raise RuntimeError("the geometry cases' octave chains cannot tell the buffer's octaves")
    return out


def geometry_check(device, textures) -> dict:
    """Phase 3j: GEOMETRY_CASES through each of GEOMETRY_INSTANCES at
    GEOMETRY_SIZE with ``renderer="kernel"`` (counters: that instance, once)
    against ``renderer="plain"``: cloud-free at atol 1e-5, rtol 1e-4, the
    others at the cloud tolerance."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    h, w = GEOMETRY_SIZE
    want = {"procedural": (1, 0, 0, 0), "cloud-free": (0, 1, 0, 0), "texture": (0, 0, 1, 0),
            "texture general": (0, 0, 0, 1)}
    out = {"conditioning": geometry_conditioning(device)}
    for spheres, boxes, octaves in GEOMETRY_CASES:
        for instance in GEOMETRY_INSTANCES:
            label = f"{instance}: {spheres} spheres, {boxes} boxes, {octaves} octaves"
            scene, cam = crowded_scene(instance, spheres, boxes, octaves, device, textures)
            mk.counters.reset()
            got = frame_array(scene.render(cam, h, w, renderer="kernel"))
            counts = (mk.counters.general_launches, mk.counters.clear_launches,
                      mk.counters.texture_launches - mk.counters.texture_general_launches,
                      mk.counters.texture_general_launches)
            if counts != want[instance] or mk.counters.plain_calls:
                raise RuntimeError(f"{label}: launched {counts}, plain "
                                   f"{mk.counters.plain_calls}")
            ref = frame_array(scene.render(cam, h, w, renderer="plain"))
            check_frame(got, label)
            if instance == "cloud-free":
                st = tight_deltas(got, ref)
                ok = st["over"] == 0.0
            else:
                st = cloud_deltas(got, ref)
                ok = cloud_tolerance_ok(st)
            log(f"[geometry] {label} {h}x{w} kernel vs plain: {json.dumps(st)}")
            if not ok:
                raise RuntimeError(f"{label}: the kernel disagrees with plain")
            out[label] = st
    return out


def lut_check(device) -> dict:
    """Phase 3j: the 256² optical-depth bake on the card against the CPU's
    (atol 1e-6 × its maximum), timed; ``clouds`` with ``od_mode="lut"`` at
    CHECK_SIZE: ``renderer="auto"`` renders the plain chain on the card (no
    K1 launch), held against the CPU's plain frame at the cloud
    tolerance; ``renderer="kernel"`` raises."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
    from godot_atmosphere_shader_tpu_torch.ops.optical_depth import bake_optical_depth

    lut = bake_optical_depth(100.0, 8.0, 0.5, device=device)
    ref = bake_optical_depth(100.0, 8.0, 0.5, device="cpu")
    bake_ms = time_cuda(lambda i: bake_optical_depth(100.0, 8.0, 0.5, device=device), 3)
    bake_cpu_ms = time_cuda(lambda i: bake_optical_depth(100.0, 8.0, 0.5, device="cpu"), 1, 0)
    err = float((lut.cpu() - ref).abs().max()) / float(ref.max())
    out = {"bake_ms": bake_ms, "bake_cpu_ms": bake_cpu_ms, "bake_rel_err": err}
    if err > 1e-6:
        raise RuntimeError(f"the card's LUT bake is {err} of its maximum off the CPU's")
    h, w = CHECK_SIZE
    frames = {}
    for dev in (device, torch.device("cpu")):
        scene, cam = scene_and_camera("clouds", "avatar", dev)
        atmo = scene.atmospheres[0]
        atmo.set_custom_shader(dataclasses.replace(atmo.config, od_mode="lut"))
        mk.counters.reset()
        frames[dev.type] = frame_array(scene.render(cam, h, w))
        counts = (mk.counters.megakernel_launches, mk.counters.plain_calls)
        out[f"{dev.type}_counters"] = counts
        if counts != (0, 1):
            raise RuntimeError(f"od_mode='lut' on {dev}: K1 {counts[0]}, plain {counts[1]}")
        if dev.type == "cuda":
            out["plain_ms"] = time_cuda(lambda i: scene.render(cam, h, w), 2, 1)
            try:
                scene.render(cam, h, w, renderer="kernel")
            except ValueError as e:
                out["kernel_refusal"] = str(e)
            else:
                raise RuntimeError("renderer='kernel' rendered an od_mode='lut' scene")
    st = cloud_deltas(frames["cuda"], frames["cpu"])
    out["card_vs_cpu"] = st
    check_frame(frames["cuda"], "od_mode=lut on the card")
    if not cloud_tolerance_ok(st):
        raise RuntimeError("the card's LUT frame disagrees with the CPU's")
    return out


def plan_timing(scene, cam, h: int, w: int, device, plain_s: float) -> dict:
    """One frame of ``Scene.render``'s plan, its launches in sequence: CUDA
    events over them (kernel ms), their device time (``torch.profiler``:
    every K1 kernel and the tile passes), the bound of each launch (the
    general texture instance's by :func:`tex_general_roofline`, the others'
    by :func:`roofline`, each with :func:`geometry_ops`) summed,
    ``Scene.render`` ms and idle share, and the plain ms (``plain_s``)."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    # Scene.render's own plan: rebased where the scene is a large world
    scene._sync_rebase(cam)
    order, params, configs = scene._sorted_layers(cam)
    dev_cam, opaque = scene._rebased_view(cam)
    configs, tex, pano_data, pano_meta = scene._kernel_plan(params, configs)
    _, params, configs, tex, bands, rows = scene._layer_bands(order, params, configs, tex,
                                                              dev_cam, h)
    launches = mk.scene_launches(params, configs, dev_cam, opaque, h, w, tex_data=tex,
                                 bands=bands, band_rows=rows, pano_data=pano_data,
                                 pano_meta=pano_meta)
    color = torch.empty((h, w, 3), device=device)
    alpha = torch.empty((h, w), device=device)
    depth = torch.empty((h, w), device=device)

    def launch(i=0):
        for _, st, args in launches:
            mk.launch(st, color, alpha, depth=depth, **args)

    def frame(i):
        scene.update(0.5 + 0.05 * i, cam)
        scene.render(cam, h, w)

    # each launch's device time alone: its kernels' (K1's, and a general
    # texture instance's tile pass or a sky's pre-pass) mean, from a trace
    # of its launches (a trace can miss some of its events)
    names = ("megakernel", "tex_choice_kernel", "sky_choice_kernel")
    device_ms = 0.0
    for _, st, args in launches:
        trace = kernel_traces(lambda st=st, args=args: [
            mk.launch(st, color, alpha, depth=depth, **args) for _ in range(KERNEL_FRAMES)], names)
        device_ms += sum(v["device_us"] for v in trace.values() if v["kernels"]) / 1e3
    t = {"kernel_ms": time_cuda(launch, KERNEL_FRAMES), "device_ms": device_ms,
         "launches_per_frame": len(launches),
         "scene_ms": time_cuda(frame, KERNEL_FRAMES)}
    busy, _ = device_busy_ms(frame, KERNEL_FRAMES, first=2 + KERNEL_FRAMES)
    t["scene_device_busy_ms"] = busy
    t["scene_idle_share"] = 1.0 - busy / t["scene_ms"] if busy > 0 else None
    scene.update(0.5, cam)
    layer_of = ([0] if launches[0][0] == "opaque" else []) + list(range(len(configs)))
    bound, parts, works = 0.0, [], []
    for (kind, st, args), li in zip(launches, layer_of):
        work = mk.work_counts(st, color, alpha, depth=depth, **args)
        per_px = (BYTES_OPAQUE_PIXEL if kind == "opaque" else BYTES_CHAINED_PIXEL
                  if st.with_background else BYTES_LAYER_PIXEL)
        tl = args["tex"]
        table_bytes = 0 if tl is None else sum(x.numel() * 4 for x in tl[1:] if x is not None)
        if tl is not None and not mk.fixed_texture_instance(st, tl[0]):
            b = tex_general_roofline(work, configs[li], st, tl[0], table_bytes,
                                     st.rows * w * per_px, extra_ops=geometry_ops(st, work))
        else:
            b = roofline(work, configs[li], h, w, table_bytes, frame_bytes=st.rows * w * per_px,
                         extra_ops=geometry_ops(st, work))
        bound += b["bound_ms"]
        parts.append({"kind": kind, "rows": st.rows, "bound_ms": b["bound_ms"],
                      "bound_by": b["bound_by"], "geometry_ops": geometry_ops(st, work)})
        works.append(work)
    t.update(bound_ms=bound, bound_by=max(parts, key=lambda x: x["bound_ms"])["bound_by"],
             launches=parts, plain_ms=plain_s * 1e3, work=works)
    return t


def cli_render(argv: list) -> tuple:
    """``cli.main(argv)`` with its standard output captured: ``(exit code,
    output lines)``."""
    import io

    from godot_atmosphere_shader_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines()


def tscn_chains(result, chains: dict, fewer: int = 0):
    """The imported scene of ``result`` (``load_tscn``) with its procedural
    fields' lacunarities and gains set by ``chains`` and, with ``fewer``,
    that many octaves and warp octaves fewer wherever a field has more than
    the launch struct holds (INLINE_OCTAVES); returns the scene."""
    from godot_atmosphere_shader_tpu_torch.models.params import ProceduralField
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    def cut(n):
        return n - fewer if n > mk.INLINE_OCTAVES else n

    atmo = result.scene.atmospheres[0]
    cfg = atmo.config
    change = {}
    for name in ("cloud_shape_noise", "cloud_coverage_noise"):
        field = getattr(cfg, name)
        if isinstance(field, ProceduralField):
            change[name] = dataclasses.replace(field, noise=dataclasses.replace(
                field.noise, octaves=cut(field.noise.octaves),
                warp_octaves=cut(field.noise.warp_octaves), **chains))
    atmo.set_custom_shader(dataclasses.replace(cfg, **change))
    return result.scene


def kernel_against_plain(scene, cam, label: str) -> tuple:
    """``scene`` at 1080p through ``renderer="kernel"`` (counters: one
    procedural K1 launch per layer, no plain call) against
    ``renderer="plain"``, with what one ulp of the camera moves the plain
    frame by, measured first (:func:`ulp_move` along :func:`camera_moves`):
    ``(kernel frame, plain frame, plain s, ulp move, statistics, whether
    they pass)`` at :func:`ulp_tolerance_ok`."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    H, W = FULL_SIZE
    scene.update(0.0, cam)
    torch.cuda.synchronize()
    t0 = time.time()
    ref = frame_array(scene.render(cam, H, W, renderer="plain"))
    plain_s = time.time() - t0
    ulp = ulp_move(scene, cam, H, W, t=0.0, moves=camera_moves(cam), base=ref)
    mk.counters.reset()
    got = frame_array(scene.render(cam, H, W, renderer="kernel"))
    if mk.counters.megakernel_launches < 1 or mk.counters.plain_calls:
        raise RuntimeError(f"{label} did not render through the kernel")
    check_frame(got, label)
    st = cloud_deltas(got, ref)
    return got, ref, plain_s, ulp, st, ulp_tolerance_ok(st, ulp)


def import_phase(device, card: str, tmp: str) -> dict:
    """Phase 8: the importer's test scene with TSCN_SPHERES spheres,
    TSCN_BOXES boxes and TSCN_OCTAVES octaves (:func:`tscn_fixture`) at
    1080p through ``cli.main(["render", "--scene", ...])``, procedural
    (``megakernel_gen``) and ``--textures`` (the general texture instance),
    with ``--stats 8``: the counters show the plan's K1 launches per frame
    and no plain call; the same scene on the card, ``renderer="kernel"``
    against ``renderer="plain"`` (:func:`kernel_against_plain`), timed
    (:func:`plan_timing`).  The procedural scene's octaves past the
    struct's: its frame with two octaves fewer through the same comparison
    (logged, since with the imported chains, whose 10th warp octave samples
    at ~2e7 lattice units, it can lie within one ulp's move), and the scene
    with GEOMETRY_CHAINS (the same spheres, boxes and octave counts), held
    the same way, whose two-octaves-fewer frame must fail."""
    from godot_atmosphere_shader_tpu_torch.models.demo import demo_camera
    from godot_atmosphere_shader_tpu_torch.models.tscn import load_tscn
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
    from godot_atmosphere_shader_tpu_torch.utils.image_io import read_png

    H, W = FULL_SIZE
    path = os.path.join(tmp, "scene.tscn")
    with open(path, "w") as f:
        f.write(tscn_fixture())
    out = {}
    for mode, flags in (("procedural", []), ("textures", ["--textures"])):
        png = os.path.join(tmp, f"frame_{mode}.png")
        result = load_tscn(path, procedural=not flags, device=device)
        scene = result.scene
        cam = demo_camera(TSCN_POSE, device=device)
        scene.update(0.0, cam)
        plan = scene_plan(scene, cam, H)
        per_frame = expected_launches(plan)
        mk.counters.reset()
        rc, lines = cli_render(["render", "--scene", path, *flags, "--pose", TSCN_POSE,
                                "--size", str(H), "--width", str(W), "--stats", "8", "-o", png])
        torch.cuda.synchronize()
        counts = {"K1": mk.counters.megakernel_launches,
                  "general": mk.counters.general_launches,
                  "texture_general": mk.counters.texture_general_launches,
                  "tile_pass": mk.counters.tex_choice_launches,
                  "clear": mk.counters.clear_launches, "plain": mk.counters.plain_calls}
        stats = json.loads(lines[-1])
        img8 = read_png(png)
        log(f"[import] {mode} 1080p through cli.main: rc {rc}, {lines[:-1]}, counters "
            f"{json.dumps(counts)} over 9 frames of {per_frame} launches ({plan_text(plan)}), "
            f"FrameStats {json.dumps(stats)}, png {img8.shape} mean {img8.mean():.3f}")
        instance = "general" if mode == "procedural" else "texture_general"
        if (rc != 0 or counts["plain"] or counts["K1"] != 9 * per_frame
                or counts[instance] != 9 or img8.shape != (H, W, 3)):
            raise RuntimeError(f"the imported scene ({mode}) did not render through the kernel")
        got, ref, plain_s, ulp, st, ok = kernel_against_plain(scene, cam, f"imported {mode}")
        s0 = mk.frame_constants(*frame_inputs(scene, cam)[0], H, W)
        log(f"[import] {mode} 1080p: one ulp of the camera moves the plain frame by "
            f"{json.dumps(ulp)}; kernel vs plain ({s0.n_spheres + s0.ext_spheres} spheres, "
            f"{s0.n_boxes + s0.ext_boxes} boxes, "
            f"scene buffer {'on' if s0.geom else 'off'}; "
            f"{ulp_tolerance_name(ulp)} tolerance): {json.dumps(st)}")
        if not ok:
            raise RuntimeError(f"the imported scene ({mode}) disagrees with plain")
        entry = dict(check=st, ulp=ulp, counters=counts, frame_stats=stats,
                     tolerance=ulp_tolerance_name(ulp))
        if mode == "procedural":
            entry["octaves"] = octave_controls(path, cam, ref, ulp, device)
        t = plan_timing(scene, cam, H, W, device, plain_s)
        log(f"[import-time] {mode} 1080p on {card}: "
            f"{json.dumps({k: v for k, v in t.items() if k != 'work'})}")
        out[mode] = dict(t, **entry)
    return out


def octave_controls(path: str, cam, ref, ulp: dict, device) -> dict:
    """Phase 8's octave controls on the imported procedural scene: its
    kernel frame with two octaves fewer against the plain frame ``ref``
    under the comparison the scene took (``ulp``; logged); and the scene
    with GEOMETRY_CHAINS, kernel against plain (:func:`kernel_against_plain`),
    then its two-octaves-fewer kernel frame against that plain frame under
    the same comparison, which must fail.  Raises where either of the
    latter does not hold."""
    from godot_atmosphere_shader_tpu_torch.models.tscn import load_tscn

    H, W = FULL_SIZE

    def kernel_frame(scene):
        scene.update(0.0, cam)
        return frame_array(scene.render(cam, H, W, renderer="kernel"))

    def scene_with(chains, fewer=0):
        return tscn_chains(load_tscn(path, procedural=True, device=device), chains, fewer)

    out = {"imported_two_fewer": cloud_deltas(kernel_frame(scene_with({}, 2)), ref)}
    out["imported_tells"] = not ulp_tolerance_ok(out["imported_two_fewer"], ulp)
    _, wc_ref, _, wc_ulp, wc_st, wc_ok = kernel_against_plain(
        scene_with(GEOMETRY_CHAINS), cam, "imported scene with GEOMETRY_CHAINS")
    out.update(chains_ulp=wc_ulp, chains_check=wc_st, chains_tolerance=ulp_tolerance_name(wc_ulp),
               chains_two_fewer=cloud_deltas(kernel_frame(scene_with(GEOMETRY_CHAINS, 2)), wc_ref))
    log(f"[import] procedural 1080p, two octaves fewer against plain: "
        f"{json.dumps(out['imported_two_fewer'])} (the comparison tells them apart: "
        f"{out['imported_tells']}); with {GEOMETRY_CHAINS}: one ulp of the camera moves the "
        f"plain frame by {json.dumps(wc_ulp)}, kernel vs plain ({out['chains_tolerance']} "
        f"tolerance) {json.dumps(wc_st)}, two octaves fewer "
        f"{json.dumps(out['chains_two_fewer'])}")
    if not wc_ok or ulp_tolerance_ok(out["chains_two_fewer"], wc_ulp):
        raise RuntimeError("the imported scene with GEOMETRY_CHAINS: the kernel disagrees with "
                           "plain, or the comparison cannot tell two octaves fewer")
    return out


def large_world_phase(device, card: str) -> dict:
    """Phase 8 at 1080p through K1: the Earth-scale scene at the origin and
    at LARGE_OFFSET (max |Δ| ≤ LARGE_WORLD_MAX), the raw-f32 control
    (``large_world=False`` at RAW_OFFSET: more than 10× the rebased error);
    the flagship ``clouds_high``/avatar translated by LARGE_OFFSET against
    itself at the origin (both ``large_world=True``), each against plain at
    the cloud tolerance; an 8-frame TAA flight of the translated flagship
    against the untranslated one."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    H, W = FULL_SIZE
    out = {}

    def k1(scene, cam, **kw):
        mk.counters.reset()
        img = frame_array(scene.render(cam, H, W, **kw))
        if mk.counters.megakernel_launches < 1 or mk.counters.plain_calls:
            raise RuntimeError("a large-world frame did not go through K1")
        return img

    base = k1(*earth_scene((0.0, 0.0, 0.0), device, True))
    check_frame(base, "earth at the origin")
    moved = k1(*earth_scene(LARGE_OFFSET, device))
    out["earth_max"] = float(np.abs(moved - base).max())
    scene, cam = earth_scene(RAW_OFFSET, device, True)
    err_lw = float(np.abs(k1(scene, cam) - base).mean())
    t0 = time.time()
    check_frame(frame_array(scene.render(cam, H, W, renderer="plain")), "plain earth")
    t = plan_timing(scene, cam, H, W, device, time.time() - t0)
    out["earth_time"] = {k: v for k, v in t.items() if k != "work"}
    err_raw = float(np.abs(k1(*earth_scene(RAW_OFFSET, device, False)) - base).mean())
    out.update(earth_rebased_mean=err_lw, earth_raw_mean=err_raw)
    log(f"[large-world] earth 1080p: translated max |d| {out['earth_max']}, at "
        f"{RAW_OFFSET} mean |d| rebased {err_lw}, raw float32 {err_raw}; timing on {card}: "
        f"{json.dumps(out['earth_time'])}")
    if out["earth_max"] > LARGE_WORLD_MAX or not err_raw > 10.0 * max(err_lw, 1e-7):
        raise RuntimeError("the rebased Earth-scale frame is not translation invariant")
    scene, cam = scene_and_camera("clouds_high", "avatar", device)
    scene.large_world = True
    scene.update(0.5, cam)
    flag = k1(scene, cam)
    far, far_cam = translated_scene(scene, cam, LARGE_OFFSET)
    far.update(0.5, far_cam)
    far_img = k1(far, far_cam)
    out["flagship_max"] = float(np.abs(far_img - flag).max())
    checks = {}
    for label, (sc, cm, img) in {"origin": (scene, cam, flag),
                                 "translated": (far, far_cam, far_img)}.items():
        torch.cuda.synchronize()
        t0 = time.time()
        checks[label] = cloud_deltas(img, frame_array(sc.render(cm, H, W, renderer="plain")))
        plain_s = time.time() - t0
        if not cloud_tolerance_ok(checks[label]):
            raise RuntimeError(f"the large-world flagship ({label}) disagrees with plain")
    out["flagship_vs_plain"] = checks
    far.update(0.5, far_cam)
    out["flagship_time"] = {k: v for k, v in plan_timing(far, far_cam, H, W, device,
                                                         plain_s).items() if k != "work"}
    log(f"[large-world] translated flagship 1080p timing on {card}: "
        f"{json.dumps(out['flagship_time'])}")
    # the path's positions on a 2^-14 grid (float32 still holds them
    # exactly), so that each translated position is exact in float64 too
    # and both flights see the same relative transforms: a position like
    # 1e-3 + 3e7 would need 59 bits
    stack = fly_path(FLIGHT_FRAMES)
    stack[:, :3, 3] = np.round(stack[:, :3, 3] * 2.0 ** 14) / 2.0 ** 14
    far_stack = stack.astype(np.float64)
    far_stack[:, :3, 3] += np.asarray(LARGE_OFFSET)
    times = flight_times(FLIGHT_FRAMES)
    mk.counters.reset()
    a = scene.render_flight(cam, times, H, W, cam_transforms=stack, taa_blend=FLIGHT_BLEND)
    b = far.render_flight(far_cam, times, H, W, cam_transforms=far_stack, taa_blend=FLIGHT_BLEND)
    torch.cuda.synchronize()
    out["flight_counters"] = (mk.counters.megakernel_launches, mk.counters.plain_calls)
    out["flight_max"] = float((a["color"] - b["color"]).abs().max())
    log(f"[large-world] flagship 1080p translated by {LARGE_OFFSET}: max |d| "
        f"{out['flagship_max']}, against plain {json.dumps(checks)}; 8-frame TAA flight max "
        f"|d| {out['flight_max']}, K1/plain {out['flight_counters']}")
    if (out["flagship_max"] > LARGE_WORLD_MAX or out["flight_max"] > LARGE_WORLD_MAX
            or out["flight_counters"] != (2 * FLIGHT_FRAMES, 0)):
        raise RuntimeError("the translated flagship or its flight differs from the origin's")
    return out


def cli_phase(device, card: str, tmp: str) -> dict:
    """Phase 8: the rest of the CLI on the card, each writing its file:
    the flagship with the glow (``render --variant clouds_high --pose
    avatar --glow`` at 1080×1920, no ``--device``), ``fly --taa --frames 8
    --size`` FLY_SIZE (K3 launched 8 times), ``bake-lut`` and
    ``export-cubemap``."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
    from godot_atmosphere_shader_tpu_torch.ops.kernels import taa
    from godot_atmosphere_shader_tpu_torch.utils.image_io import read_png

    H, W = FULL_SIZE
    out = {}
    mk.counters.reset()
    rc, lines = cli_render(["render", "--variant", "clouds_high", "--pose", "avatar", "--size",
                            str(H), "--width", str(W), "--glow", "-o",
                            os.path.join(tmp, "flagship.png")])
    out["render"] = {"rc": rc, "K1": mk.counters.megakernel_launches,
                     "plain": mk.counters.plain_calls,
                     "png": list(read_png(os.path.join(tmp, "flagship.png")).shape)}
    mk.counters.reset()
    taa.counters.reset()
    rc2, lines2 = cli_render(["fly", "--taa", "--frames", "8", "--size", str(FLY_SIZE), "-o",
                              os.path.join(tmp, "flight_")])
    torch.cuda.synchronize()
    pngs = sorted(f for f in os.listdir(tmp) if f.startswith("flight_"))
    out["fly"] = {"rc": rc2, "K1": mk.counters.megakernel_launches, "K3": taa.counters.launches,
                  "plain": mk.counters.plain_calls + taa.counters.plain_calls, "pngs": len(pngs),
                  "shape": list(read_png(os.path.join(tmp, pngs[0])).shape) if pngs else None}
    rc3, lines3 = cli_render(["bake-lut", "-o", os.path.join(tmp, "lut.npy")])
    lut = np.load(os.path.join(tmp, "lut.npy"))
    rc4, lines4 = cli_render(["export-cubemap", "-o", os.path.join(tmp, "coverage.png")])
    out["bake_lut"] = {"rc": rc3, "shape": list(lut.shape), "max": float(lut.max())}
    out["export_cubemap"] = {"rc": rc4, "png": list(read_png(
        os.path.join(tmp, "coverage.png")).shape),
        "sidecar": os.path.exists(os.path.join(tmp, "coverage.png.import"))}
    log(f"[cli] on {card}: {json.dumps(out)}; {lines + lines2 + lines3 + lines4}")
    if (out["render"]["rc"] or out["render"]["K1"] < 1 or out["render"]["plain"]
            or out["render"]["png"] != [H, W, 3] or rc2 or out["fly"]["K3"] != 8
            or out["fly"]["K1"] != 8 or out["fly"]["plain"] or out["fly"]["pngs"] != 8
            or out["fly"]["shape"] != [FLY_SIZE, FLY_SIZE, 3]
            or rc3 or out["bake_lut"]["shape"] != [256, 256] or rc4
            or out["export_cubemap"]["png"] != [512, 768] or not out["export_cubemap"]["sidecar"]):
        raise RuntimeError(f"a CLI command failed on the card: {out}")
    return out


# -- phase 9: inverse rendering ---------------------------------------------------


def fit_inputs(variant: str, pose: str, h: int, w: int, device) -> dict:
    """The CLI fit's problem on ``device``: the demo scene's true params
    (at t = 0), the start point (density 0.2, scattering strength 0.5), the
    plain frame of the true params as the target, the config, camera and
    opaque scene."""
    from godot_atmosphere_shader_tpu_torch.models.demo import build_demo_scene, demo_camera
    from godot_atmosphere_shader_tpu_torch.ops.kernels.megakernel import render_scene_plain

    scene = build_demo_scene(variant, procedural=True, device=device)
    cam = demo_camera(pose, device=device)
    scene.update(0.0, cam)
    atmo = scene.atmospheres[0]
    true = atmo.build_params().resolve_frame_state()
    with torch.no_grad():
        target = render_scene_plain((true,), (atmo.config,), cam, scene.opaque, h, w)["color"]
    start = dataclasses.replace(true, density=torch.tensor(0.2, device=device),
                                scattering_strength=torch.tensor(0.5, device=device))
    return {"true": true, "start": start, "config": atmo.config, "camera": cam,
            "opaque": scene.opaque, "target": target}


def fit_args(inp: dict) -> tuple:
    """``loss_and_gradients``'s arguments but the size: the start's seven
    knobs, the start, config, camera, opaque scene, target."""
    from godot_atmosphere_shader_tpu_torch.models.inverse import DEFAULT_TRAINABLE

    train = {k: getattr(inp["start"], k) for k in DEFAULT_TRAINABLE}
    return train, inp["start"], inp["config"], inp["camera"], inp["opaque"], inp["target"]


def on_device(obj, device):
    """A dataclass with each tensor field moved to ``device``."""
    return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).to(device)
                                       for f in dataclasses.fields(obj)
                                       if isinstance(getattr(obj, f.name), torch.Tensor)})


def step_trace(fn, steps: int) -> dict:
    """``steps`` calls of ``fn`` under ``torch.profiler``: device busy ms a
    call (the union of device intervals) and device kernels a call.  A
    small kernel and a synchronisation come first, as in
    :func:`flight_trace`.  Device activity alone: a fit step is ~120,000
    kernels, and reading their host ops too takes minutes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()
        for i in range(steps):
            fn(i)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in events if "Memcpy" not in e.name and "Memset" not in e.name]
    return {"device_busy_ms": busy_us(events) / 1e3 / steps,
            "kernels_per_step": (len(kernels) - 1) / steps}


def fit_step_profile(inp: dict, h: int, w: int, timed: int = FIT_TIMED_STEPS,
                     traced: int = FIT_TRACE_STEPS) -> dict:
    """One ``fit_step`` of ``inp``'s problem at ``h × w``: its peak memory
    (``max_memory_allocated`` over one step, and above what was allocated
    before it), ms a step by CUDA events over ``timed`` steps, and the
    device's busy ms, kernels and idle share a step in a trace of
    ``traced``."""
    from godot_atmosphere_shader_tpu_torch.models.inverse import fit_step

    args = fit_args(inp)

    def step(_):
        fit_step(*args, h, w)

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out = {"size": [h, w], "peak_bytes": peak, "step_bytes": peak - before,
           "ms_per_step": time_cuda(step, timed, warmup=0)}
    out.update(step_trace(step, traced))
    out["idle_share"] = 1.0 - out["device_busy_ms"] / out["ms_per_step"]
    return out


def fit_cli_check(device, card: str) -> dict:
    """9a: ``cli.main(["fit"])`` at the JAX defaults on the card (no
    ``--device``): one plain frame a step plus the target's, no K1 launch,
    the last loss below 0.2 × the first, the density moved toward its true
    value; then the step's ms, memory and idle share."""
    import re

    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    mk.counters.reset()
    t0 = time.perf_counter()
    rc, lines = cli_render(["fit"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"plain": mk.counters.plain_calls, "K1": mk.counters.megakernel_launches}
    nums = [[float(x) for x in re.findall(r"-?\d+\.\d+", line)] for line in lines]
    out = {"rc": rc, "lines": lines, "counters": counts, "wall_s": wall,
           "wall_ms_per_step": wall * 1e3 / FIT_CLI_STEPS}
    if rc or len(nums) != 3 or len(nums[0]) != 2 or len(nums[1]) != 3:
        raise RuntimeError(f"the CLI's fit printed something else: {out}")
    (first, last), (true_density, start_density, fitted_density) = nums[0], nums[1]
    out.update(first_loss=first, last_loss=last, fitted_density=fitted_density)
    out["profile"] = fit_step_profile(
        fit_inputs("no_clouds", "exterior", FIT_CLI_SIZE, FIT_CLI_SIZE, device),
        FIT_CLI_SIZE, FIT_CLI_SIZE)
    log(f"[fit] 9a cli fit on {card}: {json.dumps(out)}")
    if counts != {"plain": FIT_CLI_STEPS + 1, "K1": 0}:
        raise RuntimeError(f"the CLI's fit did not render one plain frame a step: {counts}")
    if not (last < 0.2 * first and abs(fitted_density - true_density)
            < abs(start_density - true_density)):
        raise RuntimeError(f"the CLI's fit did not recover the parameters: {lines}")
    return out


def fit_gradient_check(device, card: str) -> dict:
    """9b: one step's loss and gradients on ``clouds_high``/avatar at
    CHECK_SIZE, on the card and on the CPU from the same inputs (the card's
    tensors copied): each gradient element within 1e-3 of its CPU |g| plus
    1e-4 of the largest CPU |g| over the knobs, the loss within rtol 1e-5.
    Also the step's profile at this size."""
    from godot_atmosphere_shader_tpu_torch.models.inverse import loss_and_gradients

    h, w = CHECK_SIZE
    inp = fit_inputs("clouds_high", "avatar", h, w, device)
    out = {"profile": fit_step_profile(inp, h, w, timed=FIT_BIG_TIMED_STEPS, traced=1)}
    loss, grads = loss_and_gradients(*fit_args(inp), h, w)
    cpu = {k: on_device(inp[k], "cpu") for k in ("start", "camera", "opaque")}
    cpu.update(config=inp["config"], target=inp["target"].cpu())
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = loss_and_gradients(*fit_args(cpu), h, w)
    out["cpu_s"] = time.perf_counter() - t0
    top = max(float(g.abs().max()) for g in cpu_grads.values())
    ok = all(bool(torch.isfinite(g).all()) for g in (*grads.values(), *cpu_grads.values()))
    out["knobs"] = {}
    for k, g in grads.items():
        ref, g = cpu_grads[k].double(), g.cpu().double()
        tol = 1e-3 * ref.abs() + 1e-4 * top
        err = (g - ref).abs()
        ok = ok and bool((err <= tol).all())
        out["knobs"][k] = {"card": g.tolist(), "cpu": ref.tolist(),
                           "max_abs_err": float(err.max()),
                           "err_over_tolerance": float((err / tol).max())}
    loss_tol = 1e-5 * abs(float(cpu_loss))
    out.update(loss=float(loss), cpu_loss=float(cpu_loss), loss_tolerance=loss_tol,
               largest_cpu_grad=top)
    log(f"[fit] 9b gradients clouds_high/avatar {h}x{w}, card against CPU, on {card}: "
        f"{json.dumps(out)}")
    if not ok or abs(float(loss) - float(cpu_loss)) > loss_tol:
        raise RuntimeError("the card's fit gradients disagree with the CPU's")
    return out


def fit_through_k1(device, card: str) -> dict:
    """9c: FIT_K1_STEPS steps of the fit (the seven default knobs) on
    ``clouds_high``/avatar at CHECK_SIZE (plain frames only), then the
    start and the fitted params through K1 (``render_frame_megakernel``,
    what ``Scene.render`` launches; no plain call): the fitted kernel frame
    against the plain frame of the same params at the cloud tolerance, and
    its loss against the target below the start's, through the kernel too.
    The losses the fit returns alternate: ``atmosphere_ambient_color``
    (about 0.002) takes sign steps of lr = 0.05 and bounces off 0 every
    other step, so an even FIT_K1_STEPS ends in the low phase."""
    from godot_atmosphere_shader_tpu_torch.models.inverse import fit
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk

    h, w = CHECK_SIZE
    inp = fit_inputs("clouds_high", "avatar", h, w, device)
    cfg, cam, opaque, target = inp["config"], inp["camera"], inp["opaque"], inp["target"]
    mk.counters.reset()
    t0 = time.perf_counter()
    fitted, losses = fit(inp["start"], cfg, cam, opaque, target, h, w, steps=FIT_K1_STEPS)
    fit_s = time.perf_counter() - t0
    fit_counts = (mk.counters.plain_calls, mk.counters.megakernel_launches)
    mk.counters.reset()
    k_start = mk.render_frame_megakernel(inp["start"], cfg, cam, opaque, h, w)
    k_fit = mk.render_frame_megakernel(fitted, cfg, cam, opaque, h, w)
    torch.cuda.synchronize()
    k_counts = (mk.counters.megakernel_launches, mk.counters.plain_calls)
    with torch.no_grad():
        p_fit = mk.render_frame_plain(fitted, cfg, cam, opaque, h, w)
    got, ref = frame_array(k_fit), frame_array(p_fit)
    check_frame(got, "the fitted kernel frame")
    st = cloud_deltas(got, ref)

    def loss_of(out):
        return float(torch.mean((out["color"] - target) ** 2))

    out = {"losses": losses, "fit_s": fit_s, "fit_counters": {"plain": fit_counts[0],
                                                             "K1": fit_counts[1]},
           "kernel_counters": {"K1": k_counts[0], "plain": k_counts[1]},
           "fitted": {k: getattr(fitted, k).tolist() for k in ("density",
                                                               "scattering_strength")},
           "kernel_vs_plain": st, "kernel_loss_start": loss_of(k_start),
           "kernel_loss_fitted": loss_of(k_fit), "plain_loss_fitted": loss_of(p_fit)}
    log(f"[fit] 9c {FIT_K1_STEPS} steps of clouds_high/avatar {h}x{w}, then K1, on {card}: "
        f"{json.dumps(out)}")
    if fit_counts != (FIT_K1_STEPS, 0) or k_counts != (2, 0):
        raise RuntimeError(f"the fit or its K1 frames took another route: {out}")
    if not cloud_tolerance_ok(st):
        raise RuntimeError("the fitted params' K1 frame disagrees with their plain frame")
    if not (out["kernel_loss_fitted"] < out["kernel_loss_start"]
            and out["plain_loss_fitted"] < losses[0]):
        raise RuntimeError("the fit did not lower the loss through K1")
    return out


def sharded_step_check(device, card: str) -> dict:
    """9d: the sharded step on ``clouds_high``/avatar at CHECK_SIZE:
    FIT_SHARDS shards of the local mesh against the unsharded step (the
    fitter's ``loss_and_gradients``), loss and gradients at rtol 1e-5 (the
    mean of equal shard means against the whole frame's mean), the updated
    knobs finite; the step on NCCL at world size 1 against the step on the
    local mesh of one shard, loss and updated knobs bit for bit, whose loss
    is the unsharded one's, bit for bit."""
    from godot_atmosphere_shader_tpu_torch.models.inverse import loss_and_gradients
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
    from godot_atmosphere_shader_tpu_torch.parallel.sharding import (
        make_mesh, sharded_loss_and_gradients, train_step_sharded)

    h, w = CHECK_SIZE
    inp = fit_inputs("clouds_high", "avatar", h, w, device)
    args = (*fit_args(inp), h, w)
    whole_loss, whole = loss_and_gradients(*args)
    mk.counters.reset()
    loss, grads = sharded_loss_and_gradients(*args, make_mesh(FIT_SHARDS))
    counts = (mk.counters.plain_calls, mk.counters.megakernel_launches)
    _, new = train_step_sharded(*args, make_mesh(FIT_SHARDS))
    with nccl_world_of_one_mesh(device) as mesh:
        nccl_loss, nccl_new = train_step_sharded(*args, mesh)
    one_loss, one_new = train_step_sharded(*args, make_mesh(1))

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())

    out = {"counters": {"plain": counts[0], "K1": counts[1]}, "loss": float(loss),
           "whole_loss": float(whole_loss),
           "loss_rel_err": rel(loss, whole_loss),
           "grad_rel_err": {k: rel(grads[k], whole[k]) for k in grads},
           "nccl_bit_equal": bool(torch.equal(nccl_loss, one_loss) and all(
               torch.equal(nccl_new[k], one_new[k]) for k in one_new)),
           "one_shard_loss_bit_equal": bool(torch.equal(one_loss, whole_loss)),
           "finite": all(bool(torch.isfinite(v).all()) for v in new.values())}
    log(f"[fit] 9d sharded step {FIT_SHARDS} shards and NCCL world size 1, {h}x{w}, on "
        f"{card}: {json.dumps(out)}")
    if (counts != (FIT_SHARDS, 0) or not out["finite"] or not out["nccl_bit_equal"]
            or not out["one_shard_loss_bit_equal"]):
        raise RuntimeError(f"the sharded step took another route or differs: {out}")
    if out["loss_rel_err"] > 1e-5 or max(out["grad_rel_err"].values()) > 1e-5:
        raise RuntimeError("the sharded step disagrees with the unsharded one")
    return out


def fit_full_size(device, card: str, small: dict) -> dict:
    """9e: the estimate of a 1080p step's memory (9b's step at CHECK_SIZE,
    its bytes above the inputs scaled by pixels, plus those inputs), and,
    where it stays under FIT_MEMORY_LIMIT, one step's profile at 1080p."""
    H, W = FULL_SIZE
    h, w = CHECK_SIZE
    p = small["profile"]
    estimate = (p["peak_bytes"] - p["step_bytes"]) + p["step_bytes"] * (H * W) / (h * w)
    out = {"estimate_bytes": estimate, "limit_bytes": FIT_MEMORY_LIMIT,
           "ran": estimate < FIT_MEMORY_LIMIT}
    if out["ran"]:
        out["profile"] = fit_step_profile(fit_inputs("clouds_high", "avatar", H, W, device), H,
                                          W, timed=FIT_BIG_TIMED_STEPS, traced=1)
    log(f"[fit] 9e 1080p step of clouds_high/avatar on {card}: {json.dumps(out)}")
    return out


def fit_phase(device, card: str) -> dict:
    """Phase 9: inverse rendering on the card, 9a to 9e, each one's
    seconds in ``out["seconds"]``."""
    out, seconds = {}, {}
    for key, check in (("cli", fit_cli_check), ("gradients", fit_gradient_check),
                       ("k1", fit_through_k1), ("sharded", sharded_step_check)):
        t0 = time.perf_counter()
        out[key] = check(device, card)
        seconds[key] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["full_size"] = fit_full_size(device, card, out["gradients"])
    seconds["full_size"] = time.perf_counter() - t0
    out["seconds"] = seconds
    log(f"[fit] phase 9 seconds: {json.dumps(seconds)}")
    return out


def gate_phase(device, textures) -> list:
    """Phase 3k: the GPU gate's checks (``gpu_checks.run_checks`` at
    CHECK_SIZE, the run's baked textures), each result on a line of its
    own; any failed check fails the run."""
    from godot_atmosphere_shader_tpu_torch.tools import gpu_checks

    results = gpu_checks.run_checks(*CHECK_SIZE, device=device, textures=textures)
    for r in results:
        log(f"[gate] {gpu_checks.summary(r)}")
        log(f"[gate] {json.dumps(r)}")
    failed = [f"{r['variant']}/{r['pose']}" for r in results if not r["pass"]]
    if failed:
        raise RuntimeError(f"the GPU gate failed: {failed}")
    return results


def band_fidelity_phase(device, card: str, textures) -> dict:
    """Phase 7c: the band-fidelity tool (``tools/measure_band_fidelity.py``)
    at the interior pose with the run's baked textures: ``run_fits`` (K2's
    choice equal to the plain choice in every batch whose pixels all hit)
    and ``run_field_err`` on the JAX tool's first BAND_FIELD_BATCHES engaged
    batches and on every one (K2's values within K2_ATOL of the plain
    samplers, the same mode and level); K2's launches in them; then K2
    alone timed on one of the tool's calls (a tile row's 8-knot batches)
    and on the frame's 8-knot batches of every full tile row in one call,
    events and device ms, with the bound of the latter."""
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
    from godot_atmosphere_shader_tpu_torch.tools import measure_band_fidelity as bf

    geom = bf.batch_geometry("interior", device, textures=textures)
    mk.counters.reset()
    fits = bf.run_fits(geom)
    field = {"first": bf.run_field_err(geom, BAND_FIELD_BATCHES),
             "every": bf.run_field_err(geom, None)}
    torch.cuda.synchronize()
    out = {"batches": fits["batches"], "windowed": fits["windowed"], "banded": fits["banded"],
           "k2_full_batches": fits["k2_full_batches"], "k2_same_choice": fits["k2_same_choice"],
           "launches": mk.counters.texsample_launches}
    for name, res in field.items():
        out[f"field_err_{name}"] = res
    log(f"[band-fidelity] interior on {card}: {json.dumps(out)}")
    bad = [name for name, res in field.items()
           if not (res["k2_vs_plain_max"] <= K2_ATOL and res["k2_vs_plain_same_choice"])]
    if fits["k2_same_choice"] != fits["k2_full_batches"] or bad:
        raise RuntimeError(f"K2 disagrees with the plain choice or samplers in the band-fidelity "
                           f"run (fits {fits['k2_same_choice']} of {fits['k2_full_batches']}, "
                           f"field error {bad})")
    table, meta = bf._pyramid(geom)
    row = next(bf.iter_batches(geom, require_full=True))
    rows = [b for b in bf.iter_batches(geom, require_full=True)
            if b.x.shape[1] == row.x.shape[1] and int(b.index[0]) % len(bf.GROUPS) == 0]
    frame = [torch.cat([getattr(b, a) for b in rows]) for a in ("x", "y", "z")]
    timed = {}
    for name, planes in (("call", (row.x, row.y, row.z)), ("frame", frame)):
        def k2(i=0, planes=planes):
            return mk.sample_batches(table, meta, *planes, bf.WINDOW_ROWS, bf.BAND_ROWS,
                                     bf.BAND_MAX_SLICES)

        samples = planes[0].numel()
        t_ops = ops_time_ms(samples * OPS_TEX3D)
        t_bytes = (samples * 16 + table.numel() * 4) / PEAK_BYTES * 1e3
        timed[name] = {"batches": planes[0].shape[0], "samples_per_batch": planes[0].shape[1],
                       "ms": time_cuda(k2, KERNEL_FRAMES),
                       "device_ms": kernel_trace(lambda: [k2() for _ in range(KERNEL_FRAMES)],
                                                 "texsample_kernel")["device_us"] / 1e3,
                       "plan": mk.texsample_plan(planes[0].shape[0], planes[0].shape[1], True),
                       "bound_ms": max(t_ops, t_bytes),
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    out["timing"] = timed
    log(f"[band-fidelity] K2 alone on the tool's batches on {card}: {json.dumps(timed)}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the small checks: 256×384 frames, K2 alone, K3 alone, "
                         "TAA flights, the exterior and multi-planet frames, the sky, the "
                         "row shards, the procedural and texture envelopes, the gas "
                         "giant's band, the geometry and octave cases and the LUT "
                         "(phases 7b, 3 to 3j) and the GPU gate (3k)")
    args = ap.parse_args(argv)
    run_start = time.time()

    # -- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the smoke run needs one GPU")
    device = torch.device("cuda", 0)
    card = smi("name,power.limit")
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from godot_atmosphere_shader_tpu_torch.models.demo import (SHAPE_NOISE_BAKE,
                                                               COVERAGE_NOISE,
                                                               COVERAGE_SCALE,
                                                               bake_demo_textures)
    from godot_atmosphere_shader_tpu_torch.ops import sampling
    from godot_atmosphere_shader_tpu_torch.ops.kernels import library, probes, taa
    from godot_atmosphere_shader_tpu_torch.ops.kernels import megakernel as mk
    from godot_atmosphere_shader_tpu_torch.ops.kernels import texsample as ts
    from godot_atmosphere_shader_tpu_torch.render.glow import GlowSettings, apply_glow
    from godot_atmosphere_shader_tpu_torch.utils.camera import Camera

    clock("2", run_start)
    # -- 2. build -----------------------------------------------------------
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # both builds' nvcc at once
        measure = pool.submit(library.build, sources=(mk.SOURCE,),
                              defines=mk.MEASURE_DEFINES)
        path, ptxas = library.build(ptxas_info=True)
        measure_path = measure.result()[0]
    log(f"[build] {os.path.relpath(path, ROOT)} and the measurement build "
        f"{os.path.relpath(measure_path, ROOT)} in {time.time() - t0:.1f} s")
    for line in ptxas.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill", "stack", "smem")):
            log(f"[ptxas] {line.strip()}")
    mk.load_library()

    clock("7b", run_start)
    # -- 7b (run first: every bound divides by its rates). T2, the peak probe:
    # each chain against its plain version, then the measured rates ------------
    peak = peak_probe(device)
    PEAK.update(fp32=max(peak["fp32_flops"], peak["clock_fp32_flops"]),
                int32=max(peak["int32_per_s"], peak["clock_int32_per_s"]))
    # the fma launch's operations over the ceiling every bound divides by
    peak["bound_ms"] = (peak["threads"] * probes.PEAK_CHAINS * probes.PEAK_INNER["fma"]
                        * PEAK_ITERS["fma"] * 2.0 / PEAK["fp32"] * 1e3)
    log(f"[peak] T2 on {card}: {json.dumps(peak)}")
    log(f"[peak] bounds divide by fp32 {PEAK['fp32'] / 1e12:.3f} TFLOP/s (measured "
        f"{peak['fp32_flops'] / 1e12:.3f}, at the sampled clock "
        f"{peak['clock_fp32_flops'] / 1e12:.3f}, spec {SPEC_FP32 / 1e12:.0f}) and INT32 "
        f"{PEAK['int32'] / 1e12:.3f} Tinstr/s (measured {peak['int32_per_s'] / 1e12:.3f}, at the "
        f"sampled clock {peak['clock_int32_per_s'] / 1e12:.3f}, spec-derived "
        f"{SPEC_INT32 / 1e12:.3f}); the clocks under load: {peak['clocks_under_load']}")

    clock("3", run_start)
    # -- 3. kernel against plain, small --------------------------------------
    h, w = CHECK_SIZE
    for variant, pose in CHECK_CASES:
        scene, cam = scene_and_camera(variant, pose, device)
        inputs, _ = frame_inputs(scene, cam)
        got = frame_array(mk.render_frame_megakernel(*inputs, h, w))
        ref = frame_array(mk.render_frame_plain(*inputs, h, w))
        torch.cuda.synchronize()
        check_frame(got, f"kernel {variant}/{pose}")
        check_frame(ref, f"plain {variant}/{pose}")
        st = cloud_deltas(got, ref)
        log(f"[check] {variant}/{pose} {h}x{w} kernel vs plain: {json.dumps(st)}")
        if not cloud_tolerance_ok(st):
            raise RuntimeError(f"kernel disagrees with plain on {variant}/{pose}")

    clock("3b", run_start)
    # -- 3b. texture mode, small: K2 alone, then the texture scene ------------
    k2_err = k2_check(device)
    torch.cuda.synchronize()
    t0 = time.time()
    textures = bake_demo_textures(device=device)
    torch.cuda.synchronize()
    bake_s = time.time() - t0
    log(f"[bake] 64^3 shape texture and 6x256^2 coverage cubemap on the card: {bake_s:.3f} s")
    for pose in TEXTURE_POSES:
        scene, cam = scene_and_camera("clouds_high", pose, device, textures=textures)
        inputs, tex = frame_inputs(scene, cam)
        got = frame_array(mk.render_frame_megakernel(*inputs, h, w, tex_data=tex))
        ref = frame_array(mk.render_frame_plain(*inputs, h, w, tex_data=tex))
        check_frame(got, f"texture kernel {pose}")
        check_frame(ref, f"texture plain {pose}")
        st = cloud_deltas(got, ref)
        log(f"[check] clouds_high texture/{pose} {h}x{w} kernel vs plain: {json.dumps(st)}")
        if not cloud_tolerance_ok(st):
            raise RuntimeError(f"texture kernel disagrees with plain on {pose}")
    clock("3c", run_start)
    # -- 3c. flight mode, small: K3 alone at 1080p, a 4-frame TAA flight -------
    taa_err, taa_flips = taa_check(device, *FULL_SIZE)
    scene, _ = scene_and_camera("clouds_high", "avatar", device)
    stack = fly_path(SMALL_FLIGHT_FRAMES)
    cam = Camera.create(stack[0], device=device)
    times = flight_times(SMALL_FLIGHT_FRAMES)
    mk.counters.reset()
    taa.counters.reset()
    out = scene.render_flight(cam, times, h, w, cam_transforms=stack, taa_blend=FLIGHT_BLEND)
    torch.cuda.synchronize()
    counts = (mk.counters.megakernel_launches, taa.counters.launches,
              mk.counters.plain_calls + taa.counters.plain_calls)
    log(f"[flight] 4-frame TAA flight {h}x{w}: counters K1 {counts[0]}, K3 {counts[1]}, "
        f"plain {counts[2]}")
    if counts != (SMALL_FLIGHT_FRAMES, SMALL_FLIGHT_FRAMES, 0):
        raise RuntimeError("the small TAA flight did not go through K1 and K3 only")
    check_flight(f"clouds_high TAA {h}x{w}", out,
                 plain_flight(scene, cam, times, stack, h, w, FLIGHT_BLEND))

    clock("3d", run_start)
    # -- 3d. exterior and multi-planet frames, small ------------------------------
    scene_err = opaque_only_check(device, h, w)
    for kind, pose in SCENE_CASES:
        scene = build_scene(kind, device)
        cam = scene_camera(kind, pose, device)
        scene.update(0.5, cam)
        scene_err = max(scene_err, check_scene(f"{kind}/{pose}", scene, cam, h, w)[0])
    scene = build_scene("clouds_high", device, textures=textures)
    cam = scene_camera("clouds_high", "space", device)
    scene.update(0.5, cam)
    scene_err = max(scene_err, check_scene("clouds_high texture/space", scene, cam, h, w)[0])
    scene = build_scene("cell5", device)
    stack = space_path(SMALL_FLIGHT_FRAMES)
    cam = Camera.create(stack[0], device=device)
    mk.counters.reset()
    taa.counters.reset()
    out = scene.render_flight(cam, times, h, w, cam_transforms=stack, taa_blend=FLIGHT_BLEND)
    torch.cuda.synchronize()
    counts = (mk.counters.megakernel_launches, taa.counters.launches,
              mk.counters.plain_calls + taa.counters.plain_calls)
    log(f"[flight] 4-frame two-layer TAA flight {h}x{w}: counters K1 {counts[0]}, "
        f"K3 {counts[1]}, plain {counts[2]}")
    if counts != (2 * SMALL_FLIGHT_FRAMES, SMALL_FLIGHT_FRAMES, 0):
        raise RuntimeError("the two-layer TAA flight did not go through K1 and K3 only")
    scene_err = max(scene_err, check_flight(f"cell5 two-layer TAA {h}x{w}", out,
                                            plain_flight(scene, cam, times, stack, h, w,
                                                         FLIGHT_BLEND)))

    clock("3e", run_start)
    # -- 3e. the panorama sky, small ------------------------------------------------
    t0 = time.time()
    pano = synthetic_panorama(*PANO_SIZE)
    log(f"[sky] synthetic {PANO_SIZE[0]}x{PANO_SIZE[1]} panorama: {time.time() - t0:.2f} s")
    sky_err = opaque_only_check(device, h, w, pano)
    for kind, pose, textured in SKY_SCENES:
        scene = with_panorama(build_scene(kind, device, textures if textured else None), pano)
        cam = scene_camera(kind, pose, device)
        scene.update(0.5, cam)
        label = f"{kind}{'/texture' if textured else ''}/{pose} with the sky"
        sky_err = max(sky_err, check_scene(label, scene, cam, h, w)[0])
    allon_sig = {}
    # the check's own panorama is a gradient that every level reproduces;
    # the star panorama's stars show a level or mode that differs from plain
    for (pose, sky_name), sky_img in zip(
            (("avatar", "check"), ("space", "check"), ("avatar", "stars"), ("space", "stars")),
            (allon_panorama(),) * 2 + (pano,) * 2):
        scene = with_panorama(build_scene("allon", device, textures), sky_img)
        cam = scene_camera("allon", pose, device)
        scene.update(0.25, cam)
        err, img = check_scene(f"everything-on/{pose} ({sky_name} panorama)", scene, cam, h, w)
        sky_err = max(sky_err, err)
        if (pose, sky_name) == ("avatar", "check"):
            allon_sig = dict(zip(("block_mean_delta", "block_max_delta"),
                                 check_signature(img[..., :3], ALLON_SIG_PATH,
                                                 f"everything-on/avatar {h}x{w}")))
    scene = with_panorama(build_scene("clouds_high", device), pano)
    stack = fly_path(SMALL_FLIGHT_FRAMES)
    cam = Camera.create(stack[0], device=device)
    mk.counters.reset()
    taa.counters.reset()
    ts.counters.reset()
    out = scene.render_flight(cam, times, h, w, cam_transforms=stack, taa_blend=FLIGHT_BLEND)
    torch.cuda.synchronize()
    counts = (mk.counters.megakernel_launches, mk.counters.sky_launches,
              mk.counters.sky_choice_launches, taa.counters.launches,
              mk.counters.plain_calls + taa.counters.plain_calls + ts.counters.plain_sky_calls)
    log(f"[sky] 4-frame TAA flight with the sky {h}x{w}: counters K1 {counts[0]}, sky "
        f"{counts[1]}, sky pre-pass {counts[2]}, K3 {counts[3]}, plain {counts[4]}")
    if counts != (SMALL_FLIGHT_FRAMES,) * 4 + (0,):
        raise RuntimeError("the TAA flight with the sky did not go through K1 and K3 only")
    sky_err = max(sky_err, check_flight(f"clouds_high TAA with the sky {h}x{w}", out,
                                        plain_flight(scene, cam, times, stack, h, w,
                                                     FLIGHT_BLEND)))

    clock("3f", run_start)
    # -- 3f. row shards (K1 slice (g)) and the sharded TAA flight, small ----------
    from godot_atmosphere_shader_tpu_torch.parallel import sharding

    shard_err = 0.0
    for label, kind, pose, textured in (
            ("clouds_high/avatar with the sky", "clouds_high", "avatar", False),
            ("clouds_high texture/avatar with the sky", "clouds_high", "avatar", True),
            ("everything-on/avatar", "allon", "avatar", True),
            ("everything-on/space", "allon", "space", True)):
        scene = with_panorama(build_scene(kind, device, textures if textured else None), pano)
        cam = scene_camera(kind, pose, device)
        scene.update(0.25 if kind == "allon" else 0.5, cam)
        shard_err = max(shard_err, check_shards(label, scene, cam, h, w, SMALL_SHARDS,
                                                device)["vs_plain_max"])
    scene = with_panorama(build_scene("clouds_high", device), pano)
    stack = fly_path(SMALL_FLIGHT_FRAMES)
    cam = Camera.create(stack[0], device=device)
    mesh = sharding.make_mesh(SMALL_SHARDS)
    out, counts = sharded_flight(scene, cam, stack, h, w, mesh)
    log(f"[shard] 4-frame sharded TAA flight with the sky {h}x{w} on {SMALL_SHARDS} shards: "
        f"counters K1 {counts[0]}, K3 {counts[1]}, plain {counts[2]}")
    if counts != (SMALL_FLIGHT_FRAMES * SMALL_SHARDS,) * 2 + (0,):
        raise RuntimeError("the small sharded TAA flight did not go through K1 and K3 only")
    shard_err = max(shard_err, check_flight(
        f"clouds_high sharded TAA with the sky {h}x{w}", out,
        plain_flight(scene, cam, times, stack, h, w, FLIGHT_BLEND, mesh=mesh)))

    clock("3g", run_start)
    # -- 3g. K1 slice (h), the procedural envelope, small -------------------------
    conditioning = detail_conditioning(device, h, w)
    log(f"[envelope] one ulp of the camera's z, plain against plain {h}x{w}: "
        f"{json.dumps(conditioning)}")
    envelope_small = envelope_check(device, h, w)
    log(f"[envelope] {len(envelope_small)} cases {h}x{w}, one K1 launch each, no plain call: "
        f"{json.dumps(envelope_small)}")
    span = span_conditioning(device, h, w)
    log(f"[envelope] every march span one ulp longer, plain against plain {h}x{w}: "
        f"{json.dumps(span)}")
    knot_groups = knot_group_check(device, h, w, span)
    log(f"[envelope] {len(knot_groups)} knot-group cases {h}x{w}: {json.dumps(knot_groups)}")

    clock("3h", run_start)
    # -- 3h. K1 slice (i), the texture envelope, small -------------------------
    th, tw = TEX_ENVELOPE_SIZE
    tex_cond = tex_envelope_conditioning(device, textures, th, tw)
    log(f"[tex-envelope] one ulp of the camera (full quality) and of every march span "
        f"(G = 32), plain against plain {th}x{tw}: {json.dumps(tex_cond)}")
    tex_small = tex_envelope_check(device, textures, th, tw, tex_cond)
    log(f"[tex-envelope] {len(tex_small)} cases {th}x{tw}, one texture launch each, no plain "
        f"call: {json.dumps(tex_small)}")

    clock("3i", run_start)
    # -- 3i. the gas giant's limb band against three references -----------------
    gas_giant = gas_giant_check(device)
    clock("3j", run_start)
    # -- 3j. K1 sized per scene: spheres, boxes and octaves past the launch
    # struct's inline ones through each instance; the LUT's route ----------------
    geometry = geometry_check(device, textures)
    lut = lut_check(device)
    log(f"[lut] on {card}: {json.dumps(lut)}")
    clock("3k", run_start)
    # -- 3k. the GPU gate (the port's tools/gpu_checks.py), in this process -------
    gate = gate_phase(device, textures)
    if args.quick:
        return 1

    clock("4", run_start)
    # -- 4. the procedural slice at 1080p through Scene.render -----------------
    H, W = FULL_SIZE
    runs = {}
    mk.counters.reset()
    for variant, pose in (("clouds_high", "avatar"), ("clouds_high", "interior"),
                          ("clouds", "avatar")):
        scene, cam = scene_and_camera(variant, pose, device)
        runs[(variant, pose)] = (scene, cam, scene.render(cam, H, W))
    torch.cuda.synchronize()
    launches, plain = mk.counters.megakernel_launches, mk.counters.plain_calls
    log(f"[slice] counters after 3 Scene.render frames: kernel {launches}, "
        f"texture {mk.counters.texture_launches}, plain {plain}")
    if launches != 3 or plain != 0 or mk.counters.texture_launches != 0:
        raise RuntimeError("the 1080p frames did not all go through the kernel")
    max_err = 0.0
    for (variant, pose), (scene, cam, out) in runs.items():
        img = frame_array(out)
        check_frame(img, f"1080p {variant}/{pose}")
        log(f"[slice] {variant}/{pose} 1080p: mean {img[..., :3].mean():.6f} "
            f"alpha mean {img[..., 3].mean():.6f}")
        ref = frame_array(mk.render_frame_plain(*frame_inputs(scene, cam)[0], H, W))
        check_frame(ref, f"plain 1080p {variant}/{pose}")
        st = cloud_deltas(img, ref)
        log(f"[slice] {variant}/{pose} 1080p kernel vs plain: {json.dumps(st)}")
        if not cloud_tolerance_ok(st):
            raise RuntimeError(f"1080p kernel disagrees with plain on {variant}/{pose}")
        max_err = max(max_err, st["max"])
    check_signature(frame_array(runs[("clouds_high", "avatar")][2])[..., :3], SIG_PATH,
                    "clouds_high/avatar 1080p")

    clock("4b", run_start)
    # -- 4b. the texture slice at 1080p through Scene.render ---------------------
    tex_runs = {}
    pyramid_s = {}
    mk.counters.reset()
    for pose in TEXTURE_POSES:
        scene, cam = scene_and_camera("clouds_high", pose, device, textures=textures)
        torch.cuda.synchronize()
        t0 = time.time()
        _, params, configs = scene._sorted_layers(cam)
        scene._texture_plan(params[0], configs[0])  # builds and uploads the pyramids
        torch.cuda.synchronize()
        pyramid_s[pose] = time.time() - t0
        tex_runs[pose] = (scene, cam, scene.render(cam, H, W))
    torch.cuda.synchronize()
    tex_launches = mk.counters.texture_launches
    log(f"[texture] counters after 2 Scene.render frames: kernel {mk.counters.megakernel_launches}, "
        f"texture {tex_launches}, plain {mk.counters.plain_calls}")
    if tex_launches != 2 or mk.counters.megakernel_launches != 2 or mk.counters.plain_calls:
        raise RuntimeError("the 1080p texture frames did not all go through the texture kernel")
    log(f"[texture] one-off set-up: bake {bake_s:.3f} s; pyramid build and upload "
        + ", ".join(f"{p} {s:.3f} s" for p, s in pyramid_s.items())
        + " (cold: avatar; interior reuses nothing, it is a new scene)")
    tex_err = 0.0
    for pose, (scene, cam, out) in tex_runs.items():
        img = frame_array(out)
        check_frame(img, f"1080p texture {pose}")
        log(f"[texture] clouds_high/{pose} 1080p: mean {img[..., :3].mean():.6f} "
            f"alpha mean {img[..., 3].mean():.6f}")
        inputs, tex = frame_inputs(scene, cam)
        ref = frame_array(mk.render_frame_plain(*inputs, H, W, tex_data=tex))
        check_frame(ref, f"plain 1080p texture {pose}")
        st = cloud_deltas(img, ref)
        log(f"[texture] clouds_high/{pose} 1080p kernel vs plain: {json.dumps(st)}")
        if not cloud_tolerance_ok(st):
            raise RuntimeError(f"1080p texture kernel disagrees with plain on {pose}")
        tex_err = max(tex_err, st["max"])
    for size, bake in ((16, lambda dev: sampling.bake_noise_texture3d(SHAPE_NOISE_BAKE, 16,
                                                                      device=dev)),
                       (32, lambda dev: sampling.bake_noise_cubemap(COVERAGE_NOISE,
                                                                    COVERAGE_SCALE, 32,
                                                                    device=dev))):
        err = float((bake(device).cpu() - bake("cpu")).abs().max())
        log(f"[bake] card vs CPU bake at {size}: max |Δ| {err:.3g} (atol {BAKE_ATOL})")
        if not err <= BAKE_ATOL:
            raise RuntimeError(f"the card's bake disagrees with the CPU bake at {size}")

    clock("4c", run_start)
    # -- 4c. the JAX bench cells 1, 2, 5 and 7 through Scene.render ---------------
    cells = {}
    mk.counters.reset()
    cell_launches = 0
    clear_launches, clear_err = {"4c": 0}, 0.0  # the cloud-free instance's
    for cell, kind, pose, ch, cw in BENCH_CELLS:
        scene = build_scene(kind, device)
        cam = scene_camera(kind, pose, device)
        scene.update(0.5, cam)
        err = check_scene(f"cell {cell} {kind}/{pose}", scene, cam, ch, cw)[0]
        scene_err = max(scene_err, err)
        clear_launches["4c"] += mk.counters.clear_launches
        plan = scene_plan(scene, cam, ch)
        if not any(c.clouds_enabled for c in plan[1]):
            clear_err = max(clear_err, err)
        cell_launches += expected_launches(plan)
        cells[cell] = (kind, scene, cam, ch, cw, plan)

    clock("4d", run_start)
    # -- 4d. the panorama sky at 1080p through Scene.render, and the glow ----------
    sky_runs, sky_launches, choice_launches = {}, 0, 0
    pyramid_s = {}
    mk.counters.reset()
    ts.counters.reset()
    for label, kind, pose, textured in SKY_FRAMES:
        scene = with_panorama(build_scene(kind, device, textures if textured else None), pano)
        cam = scene_camera(kind, pose, device)
        scene.update(0.25 if kind == "allon" else 0.5, cam)
        plan = scene_plan(scene, cam, H)
        torch.cuda.synchronize()
        t0 = time.time()
        scene._pano_plan()  # builds and uploads the sky's pyramids
        torch.cuda.synchronize()
        pyramid_s[label] = time.time() - t0
        sky_runs[label] = (scene, cam, plan, scene.render(cam, H, W))
        sky_launches += expected_launches(plan)
        choice_launches += expected_choice_launches(plan, True)
    torch.cuda.synchronize()
    sky_counts = (mk.counters.megakernel_launches, mk.counters.sky_launches,
                  mk.counters.sky_choice_launches,
                  mk.counters.plain_calls + ts.counters.plain_sky_calls)
    log(f"[sky] counters after {len(SKY_FRAMES)} 1080p Scene.render frames with the sky: K1 "
        f"{sky_counts[0]} (texture {mk.counters.texture_launches}), sky {sky_counts[1]}, "
        f"sky pre-pass {sky_counts[2]}, plain {sky_counts[3]}; pyramid build and upload "
        + ", ".join(f"{k} {v:.3f} s" for k, v in pyramid_s.items()))
    if sky_counts != (sky_launches, len(SKY_FRAMES), choice_launches, 0):
        raise RuntimeError("the 1080p frames with the sky did not go through K1 only")
    clear_launches["4d"] = mk.counters.clear_launches
    sky_frame_err = 0.0
    for label, (scene, cam, plan, out) in sky_runs.items():
        img = frame_array(out)
        check_frame(img, f"1080p {label} with the sky")
        params, configs, tex, bands, rows = plan
        pano_data, pano_meta = scene._pano_plan()
        ref = frame_array(mk.render_scene_plain(params, configs, cam, scene.opaque, H, W,
                                                tex_data=tex, bands=bands, band_rows=rows,
                                                pano_data=pano_data, pano_meta=pano_meta))
        check_frame(ref, f"plain 1080p {label} with the sky")
        st = cloud_deltas(img, ref)
        log(f"[sky] {label} 1080p: plan [{plan_text(plan)}], mean {img[..., :3].mean():.6f}, "
            f"alpha mean {img[..., 3].mean():.6f}; kernel vs plain: {json.dumps(st)}")
        if not cloud_tolerance_ok(st):
            raise RuntimeError(f"1080p {label} with the sky disagrees with plain")
        sky_frame_err = max(sky_frame_err, st["max"])
    # the pre-pass alone against its plain version on each frame it serves
    choice_err, choice_inputs = 0, {}
    for label, (scene, cam, plan, _) in sky_runs.items():
        kind, struct, args = sky_launch(scene, cam, plan, H, W)
        if args["tex"] is not None:
            continue
        sky_params = args["sky"][0]
        got = mk.sky_choices(struct, sky_params, device).cpu()
        ref = mk.sky_choices_plain(cam, H, W, scene._pano_plan()[1]).cpu()
        err = int((got - ref).abs().max())
        log(f"[sky] pre-pass alone on {label} 1080p ({kind}): {got.shape[0]} tiles, levels "
            f"{sorted(set(got[:, 1].tolist()))}, floor tiles {int((got[:, 0] == ts.FLOOR).sum())}, "
            f"max |Δ| against plain {err}")
        if err:
            raise RuntimeError(f"the sky's pre-pass disagrees with plain on {label}")
        choice_err = max(choice_err, err)
        choice_inputs[label] = (struct, sky_params, cam, scene._pano_plan()[1])
    glow_err, glow_change = 0.0, {}
    for label in ("everything-on/avatar", "clouds_high/sunward"):
        scene, _, _, out = sky_runs[label]
        scene.environment = GlowSettings.demo()
        glowed = scene.apply_environment(out["color"])
        ref = apply_glow(out["color"].cpu(), GlowSettings.demo())
        err = float((glowed.cpu() - ref).abs().max())
        glow_change[label] = float((glowed - out["color"]).abs().max())
        log(f"[glow] {label} 1080p: card vs CPU max |Δ| {err:.3g} (atol {GLOW_ATOL}), the glow "
            f"adds up to {glow_change[label]:.4g}")
        if not err <= GLOW_ATOL or not torch.isfinite(glowed).all():
            raise RuntimeError(f"the glow of {label} disagrees between the card and the CPU")
        glow_err = max(glow_err, err)
    if not glow_change["clouds_high/sunward"] > 1e-2:
        raise RuntimeError("the sunward frame's HDR sun disc did not bloom")

    clock("4e", run_start)
    # -- 4e. row shards at full size: the sharded frame, the 1080p flagship on
    # two shards, the sharded TAA flight, NCCL world size 1, K3's band mode ----
    SH, SW = SHARD_SIZE
    mesh = sharding.make_mesh(SHARDS)
    allon = with_panorama(build_scene("allon", device, textures), pano)
    allon_cam = scene_camera("allon", "avatar", device)
    allon.update(0.25, allon_cam)
    allon_in = shard_inputs(allon, allon_cam)
    flag_scene, flag_cam = scene_and_camera("clouds_high", "avatar", device)
    flag_in = shard_inputs(flag_scene, flag_cam)
    flight_scene, _ = scene_and_camera("clouds_high", "avatar", device)
    shard_stack = fly_path(FLIGHT_FRAMES)
    flight_cam = Camera.create(shard_stack[0], device=device)
    # the main path, its counters set to 0 just before and read just after
    mk.counters.reset()
    ts.counters.reset()
    taa.counters.reset()
    shard_frame = sharding.render_scene_megakernel_sharded(
        *allon_in[:2], allon_cam, allon.opaque, SH, SW, mesh, tex_data=allon_in[2],
        pano_data=allon_in[3], pano_meta=allon_in[4])
    torch.cuda.synchronize()
    frame_counts = band_counts()
    clear_launches["4e"] = mk.counters.clear_launches
    flag_color = sharding.render_frame_megakernel_sharded(
        flag_in[0][0], flag_in[1][0], flag_cam, flag_scene.opaque, H, W,
        sharding.make_mesh(FLAGSHIP_SHARDS))
    torch.cuda.synchronize()
    flag_counts = tuple(a - b for a, b in zip(band_counts(), frame_counts))
    mk.counters.reset()
    taa.counters.reset()
    shard_out = flight_scene.render_flight(flight_cam, flight_times(FLIGHT_FRAMES), SH, SW,
                                           cam_transforms=shard_stack, taa_blend=FLIGHT_BLEND,
                                           mesh=mesh)
    torch.cuda.synchronize()
    flight_counts = (mk.counters.megakernel_launches, taa.counters.launches,
                     mk.counters.plain_calls + taa.counters.plain_calls)
    band_k1 = frame_counts[0] + flag_counts[0] + flight_counts[0]
    band_k3 = flight_counts[1]
    log(f"[shard] main path counters: everything-on {SH}x{SW} on {SHARDS} shards K1/sky/"
        f"pre-pass/plain {frame_counts}, clouds_high/avatar {H}x{W} on {FLAGSHIP_SHARDS} "
        f"shards {flag_counts}, {FLIGHT_FRAMES}-frame sharded TAA flight K1/K3/plain "
        f"{flight_counts}")
    if (frame_counts != expected_band_counts(allon_in[1], SHARDS, True)
            or flag_counts != (FLAGSHIP_SHARDS, 0, 0, 0)
            or flight_counts != (FLIGHT_FRAMES * SHARDS, FLIGHT_FRAMES * SHARDS, 0)):
        raise RuntimeError("the sharded main path did not go through the planned K1 and K3 "
                           "launches only")
    shard_cmp = {}
    img = frame_array(shard_frame)
    check_frame(img, "sharded everything-on")
    for name, ref in (("plain", shard_frames(allon_in, allon, allon_cam, SH, SW, SHARDS,
                                             plain=True)),
                      ("single-card Scene.render", allon.render(allon_cam, SH, SW))):
        st = cloud_deltas(img, frame_array(ref))
        shard_cmp[f"everything-on vs {name}"] = st
        log(f"[shard] everything-on/avatar {SH}x{SW} on {SHARDS} shards vs {name}: "
            f"{json.dumps(st)}")
        if not cloud_tolerance_ok(st):
            raise RuntimeError(f"the sharded everything-on frame disagrees with {name}")
    img = flag_color.cpu().numpy()
    for name, ref in (("plain", shard_frames(flag_in, flag_scene, flag_cam, H, W,
                                             FLAGSHIP_SHARDS, plain=True)["color"]),
                      ("single-card Scene.render", flag_scene.render(flag_cam, H, W)["color"])):
        st = cloud_deltas(img, ref.cpu().numpy())
        shard_cmp[f"clouds_high/avatar 1080p vs {name}"] = st
        log(f"[shard] clouds_high/avatar {H}x{W} on {FLAGSHIP_SHARDS} shards vs {name}: "
            f"{json.dumps(st)}")
        if not cloud_tolerance_ok(st):
            raise RuntimeError(f"the sharded 1080p flagship disagrees with {name}")
    shard_flight_err = check_flight(
        f"clouds_high sharded TAA {SH}x{SW}", shard_out,
        plain_flight(flight_scene, flight_cam, flight_times(FLIGHT_FRAMES), shard_stack, SH, SW,
                     FLIGHT_BLEND, mesh=mesh))
    single = flight_scene.render_flight(flight_cam, flight_times(FLIGHT_FRAMES), SH, SW,
                                        cam_transforms=shard_stack, taa_blend=FLIGHT_BLEND)
    shard_cmp["flight vs single-card flight"] = check_flight(
        f"clouds_high sharded TAA {SH}x{SW} vs the single-card flight", shard_out, single)
    shard_err = max(shard_err, shard_flight_err,
                    *(v["max"] for k, v in shard_cmp.items() if k.endswith("plain")))

    def nccl_frame(m):
        return sharding.render_scene_megakernel_sharded(
            *allon_in[:2], allon_cam, allon.opaque, SH, SW, m, tex_data=allon_in[2],
            pano_data=allon_in[3], pano_meta=allon_in[4])

    def nccl_flight(m):
        return flight_scene.render_flight(flight_cam, flight_times(FLIGHT_FRAMES), SH, SW,
                                          cam_transforms=shard_stack, taa_blend=FLIGHT_BLEND,
                                          mesh=m)

    nccl = nccl_world_of_one(device, nccl_frame, nccl_flight)
    log(f"[shard] torch.distributed world size 1 against the local mesh of one shard: "
        f"{json.dumps(nccl)}")
    taa_band = taa_band_check(device, SH, SW, SHARDS, TAA_HALO)
    log(f"[taa-band] K3 band mode alone {SH}x{SW}, {SHARDS} shards, halo {TAA_HALO} on "
        f"{card}: {json.dumps(taa_band)}")

    clock("4f", run_start)
    # -- 4f. K1 slice (h): the envelope's four frames at 1080p through Scene.render
    env_runs = {}
    mk.counters.reset()
    ts.counters.reset()
    for name in ENVELOPE_FRAMES:
        scene, cam = envelope_scene(name, device)
        env_runs[name] = (scene, cam, scene.render(cam, H, W))
    torch.cuda.synchronize()
    env_counts = (mk.counters.megakernel_launches, mk.counters.general_launches,
                  mk.counters.plain_calls + ts.counters.plain_sky_calls)
    log(f"[envelope] counters after {len(ENVELOPE_FRAMES)} 1080p Scene.render frames: K1 "
        f"{env_counts[0]} (procedural {env_counts[1]}), plain {env_counts[2]}")
    if env_counts != (len(ENVELOPE_FRAMES),) * 2 + (0,):
        raise RuntimeError("the envelope's 1080p frames did not all go through the "
                           "procedural instance")
    env_check = {}
    for name, (scene, cam, out) in env_runs.items():
        img = frame_array(out)
        check_frame(img, f"1080p {name}")
        env_check[name] = check_envelope_frame(name, scene, cam, img, H, W)

    clock("4g", run_start)
    # -- 4g. K1 slice (i): the texture envelope's frames at 1080p, each against
    # the whole plain frame, then timed ------------------------------------------
    tex_env = tex_envelope_frames(device, textures, H, W, tex_cond)
    for name, t in tex_env["frames"].items():
        log(f"[tex-envelope-time] {name} 1080p on {card}: "
            f"{json.dumps({k: v for k, v in t.items() if k != 'work'})}")
        log(f"[tex-envelope-time] {name} work: {json.dumps(t['work'])}")
    both = both_texture_instances(device, textures, H, W)
    log(f"[tex-envelope-time] bench cell 6 (the demo's texture profile) through both texture "
        f"instances on {card}: {json.dumps(both)}")
    log(f"[tex-envelope-time] after timing: "
        f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    clock("5", run_start)
    # -- 5. timing -------------------------------------------------------------
    timings, bounds = {}, {}
    cases = [("clouds_high", "avatar", None), ("clouds_high", "interior", None),
             ("clouds", "avatar", None)] + [("clouds_high", p, textures) for p in TEXTURE_POSES]
    for variant, pose, tx in cases:
        label = f"{variant}{'/texture' if tx is not None else ''}/{pose}"
        scene, cam = scene_and_camera(variant, pose, device, textures=tx)
        inputs, tex = frame_inputs(scene, cam)
        struct = mk.frame_constants(*inputs, H, W)
        tex_launch = None if tex is None else (mk.tex_constants(inputs[1]), *tex)
        color = torch.empty((H, W, 3), device=device)
        alpha = torch.empty((H, W), device=device)

        def launch(i):
            mk.launch(struct, color, alpha, tex=tex_launch)

        def frame(i):
            scene.update(0.5 + 0.05 * i, cam)
            scene.render(cam, H, W)

        def plain(i):
            scene.update(0.5 + 0.05 * i, cam)
            ins, tx_data = frame_inputs(scene, cam)
            mk.render_frame_plain(*ins, H, W, tex_data=tx_data)

        t = {"kernel_ms": time_cuda(launch, KERNEL_FRAMES),
             "scene_ms": time_cuda(frame, KERNEL_FRAMES),
             "plain_ms": time_cuda(plain, PLAIN_FRAMES, warmup=1)}
        for k in list(t):
            t[k.replace("_ms", "_mrays")] = H * W / (t[k] * 1e-3) / 1e6
        busy, kernel = device_busy_ms(frame, KERNEL_FRAMES, first=2 + KERNEL_FRAMES)
        # a trace without device time measures nothing: no idle share then
        t["scene_device_busy_ms"] = busy
        t["scene_megakernel_device_ms"] = kernel
        t["scene_idle_share"] = 1.0 - busy / t["scene_ms"] if busy > 0 else None
        work = mk.work_counts(struct, color, alpha, tex=tex_launch)
        table_bytes = 0 if tex is None else sum(x.numel() * 4 for x in tex)
        bounds[label] = dict(roofline(work, inputs[1], H, W, table_bytes), work=work)
        t["bound_ms"] = bounds[label]["bound_ms"]
        timings[label] = t
        log(f"[time] {label} 1080p on {card}: {json.dumps(t)}")
        log(f"[bound] {label}: {json.dumps(bounds[label])}")
    log(f"[time] after timing: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    clock("5b", run_start)
    # -- 5b. the bench cells' timing: per launch, per frame, plain ---------------------
    cell_t = {}
    for cell, (kind, scene, cam, ch, cw, plan) in cells.items():
        t = launch_timing(plan, scene, cam, ch, cw, device)

        def frame(i, scene=scene, cam=cam, ch=ch, cw=cw):
            scene.update(0.5 + 0.05 * i, cam)
            scene.render(cam, ch, cw)

        def plain(i, scene=scene, cam=cam, ch=ch, cw=cw):
            scene.update(0.5 + 0.05 * i, cam)
            params, configs, tex, bands, rows = scene_plan(scene, cam, ch)
            mk.render_scene_plain(params, configs, cam, scene.opaque, ch, cw, tex_data=tex,
                                  bands=bands, band_rows=rows)

        t["scene_ms"] = time_cuda(frame, KERNEL_FRAMES)
        busy, kernel = device_busy_ms(frame, KERNEL_FRAMES, first=2 + KERNEL_FRAMES)
        t["scene_device_busy_ms"] = busy
        t["scene_megakernel_device_ms"] = kernel
        t["scene_idle_share"] = 1.0 - busy / t["scene_ms"] if busy > 0 else None
        t["plain_ms"] = time_cuda(plain, SCENE_PLAIN_FRAMES, warmup=0)
        t["plan"] = plan_text(plan)
        scene.update(0.5, cam)
        cell_t[cell] = t
        log(f"[cell-time] cell {cell} {kind} {ch}x{cw} on {card}: {json.dumps(t)}")
    # cell 5: the same frame with bands=None forced, and the planet band
    # without raymarched lighting
    kind, scene, cam, ch, cw, plan = cells["5"]
    params, configs, tex, bands, rows = plan
    full = launch_timing((params, configs, tex, None, None), scene, cam, ch, cw, device)
    cheap = list(configs)
    cheap[0] = dataclasses.replace(configs[0], raymarched_lighting=False)
    no_rm = launch_timing((params, tuple(cheap), tex, bands, rows), scene, cam, ch, cw, device)
    planet = [x for x in cell_t["5"]["launches"] if x["layer"] == 0 and x["kind"] != "opaque"]
    planet_cheap = [x for x in no_rm["launches"] if x["layer"] == 0 and x["kind"] != "opaque"]
    cell5_cmp = {"banded_frame_kernel_ms": cell_t["5"]["frame_kernel_ms"],
                 "fullscreen_frame_kernel_ms": full["frame_kernel_ms"],
                 "fullscreen_launches": [{k: x[k] for k in ("kind", "rows", "ms", "bound_ms")}
                                         for x in full["launches"]],
                 "planet_band_rm_ms": planet[0]["ms"],
                 "planet_band_cheap_light_ms": planet_cheap[0]["ms"],
                 "planet_band_cheap_light_bound_ms": planet_cheap[0]["bound_ms"]}
    log(f"[cell-time] cell 5 comparisons on {card}: {json.dumps(cell5_cmp)}")
    log(f"[cell-time] after timing: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    clock("5c", run_start)
    # -- 5c. the sky's timing: per launch, per frame, plain; glow; the sky's cost ------
    from godot_atmosphere_shader_tpu_torch.render.renderer import opaque_only_config, render_frame

    sky_t = {}
    for label, (scene, cam, plan, out) in sky_runs.items():
        t = launch_timing(plan, scene, cam, H, W, device)
        base = 0.25 if label.startswith("everything-on") else 0.5

        def frame(i, scene=scene, cam=cam, base=base):
            scene.update(base + 0.05 * i, cam)
            scene.render(cam, H, W)

        def plain(i, scene=scene, cam=cam, base=base):
            scene.update(base + 0.05 * i, cam)
            params, configs, tex, bands, rows = scene_plan(scene, cam, H)
            pano_data, pano_meta = scene._pano_plan()
            mk.render_scene_plain(params, configs, cam, scene.opaque, H, W, tex_data=tex,
                                  bands=bands, band_rows=rows, pano_data=pano_data,
                                  pano_meta=pano_meta)

        t["scene_ms"] = time_cuda(frame, KERNEL_FRAMES)
        busy, kernel = device_busy_ms(frame, KERNEL_FRAMES, first=2 + KERNEL_FRAMES)
        t["scene_device_busy_ms"] = busy
        t["scene_megakernel_device_ms"] = kernel
        t["scene_idle_share"] = 1.0 - busy / t["scene_ms"] if busy > 0 else None
        t["plain_ms"] = time_cuda(plain, SCENE_PLAIN_FRAMES, warmup=0)
        t["plan"] = plan_text(plan)
        scene.update(base, cam)
        sky_t[label] = t
        log(f"[sky-time] {label} 1080p on {card}: {json.dumps(t)}")
    scene, _, _, out = sky_runs["everything-on/avatar"]
    glow_t = {"ms": time_cuda(lambda i: scene.apply_environment(out["color"]), KERNEL_FRAMES),
              "cpu_ms": time_cuda(lambda i: apply_glow(out["color"].cpu(), scene.environment),
                                  1, warmup=0)}
    log(f"[glow-time] GlowSettings.demo() at 1080p on {card}: {json.dumps(glow_t)}")
    # the opaque-only pass of the everything-on/space plan (timed with the
    # sky and without above) and its plain version alone
    scene, cam, plan, _ = sky_runs["everything-on/space"]
    params, configs = plan[0], plan[1]
    pano_data, pano_meta = scene._pano_plan()
    opaque_sky = sky_t["everything-on/space"]["launches"][0]
    if opaque_sky["kind"] != "opaque" or not opaque_sky["sky"]:
        raise RuntimeError("the everything-on/space plan does not start with the sky's "
                           "opaque-only pass")
    opaque_sky["plain_ms"] = time_cuda(lambda i: render_frame(
        params[0], opaque_only_config(configs[0]), cam, scene.opaque, H, W,
        with_atmosphere=False, pano_data=pano_data, pano_meta=pano_meta), 1, warmup=1)
    sky_cost_ms = {label: [x["ms"] - x["no_sky_ms"] for x in t["launches"] if x["sky"]][0]
                   for label, t in sky_t.items()}
    log(f"[sky-time] the sky's cost per frame (sky launch with the sky minus without) on "
        f"{card}: {json.dumps(sky_cost_ms)}; opaque-only pass plain ms "
        f"{opaque_sky['plain_ms']:.3f}")
    # the sky's pre-pass alone on each frame it serves: CUDA events (the
    # ctypes launch included), its kernel's device time in a trace, its
    # plain version on the card, its bound
    ty, tx = mk.tile_grid(H, W)
    t_ops = ops_time_ms(ty * tx * 32 * 128 * OPS_SKY_CHOICE_RAY)
    t_bytes = ty * tx * 8 / PEAK_BYTES * 1e3
    choice_t = {}
    for label, (struct, sky_params, cam, meta) in choice_inputs.items():
        def run(i, st=struct, sp=sky_params):
            mk.sky_choices(st, sp, device)

        choice_t[label] = {
            "ms": time_cuda(run, KERNEL_FRAMES),
            "device_ms": kernel_trace(lambda: [run(i) for i in range(KERNEL_FRAMES)],
                                      "sky_choice_kernel")["device_us"] / 1e3,
            "plain_ms": time_cuda(lambda i, c=cam, m=meta: mk.sky_choices_plain(c, H, W, m),
                                  PLAIN_FRAMES),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        log(f"[sky-time] pre-pass alone on {label} 1080p on {card}: {json.dumps(choice_t[label])}")
    log(f"[sky-time] after timing: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    clock("5d", run_start)
    # -- 5d. row shards' timing: per-shard K1 with its bound, the sharded frame
    # against the single-card frame, the sharded flight ------------------------
    shard_t = {"everything-on": band_timing(allon, allon_cam, SH, SW, SHARDS, device),
               "clouds_high/avatar 1080p": band_timing(flag_scene, flag_cam, H, W,
                                                      FLAGSHIP_SHARDS, device)}
    shard_t["everything-on"]["single_card"] = launch_timing(
        scene_plan(allon, allon_cam, SH), allon, allon_cam, SH, SW, device)
    shard_t["clouds_high/avatar 1080p"]["single_card_kernel_ms"] = (
        timings["clouds_high/avatar"]["kernel_ms"])
    for label, t in shard_t.items():
        log(f"[shard-time] {label} on {card}: {json.dumps(t)}")
    best = None
    for r in range(FLIGHT_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flight_scene.render_flight(flight_cam, flight_times(FLIGHT_FRAMES, 1.0 + r), SH, SW,
                                   cam_transforms=shard_stack, taa_blend=FLIGHT_BLEND, mesh=mesh)
        t_host = time.perf_counter() - t0
        torch.cuda.synchronize()
        t_all = time.perf_counter() - t0
        if best is None or t_all < best[1]:
            best = (t_host, t_all)
    trace = flight_trace(lambda: flight_scene.render_flight(
        flight_cam, flight_times(FLIGHT_FRAMES, 5.0), SH, SW, cam_transforms=shard_stack,
        taa_blend=FLIGHT_BLEND, mesh=mesh))
    shard_flight_t = {"flight_ms_per_frame": best[1] / FLIGHT_FRAMES * 1e3,
                      "host_ms_per_frame": best[0] / FLIGHT_FRAMES * 1e3,
                      "device_busy_ms_per_frame": trace["device_busy_ms"] / FLIGHT_FRAMES,
                      "idle_share": 1.0 - trace["device_busy_ms"] / (best[1] * 1e3),
                      "frame_kernels_in_trace": trace["frame_kernels"],
                      "d2h_copies": trace["d2h_copies"],
                      "d2h_copies_in_loop": trace["d2h_copies_in_loop"]}
    log(f"[shard-time] {FLIGHT_FRAMES}-frame sharded TAA flight {SH}x{SW} on {SHARDS} shards on "
        f"{card}: {json.dumps(shard_flight_t)}")
    log(f"[shard-time] after timing: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    band_flag = shard_t["clouds_high/avatar 1080p"]

    clock("5e", run_start)
    # -- 5e. the envelope's timing: per frame kernel ms and bound, Scene.render ms
    # and idle share, plain ms ---------------------------------------------------
    env_t = {}
    for name, (scene, cam, _) in env_runs.items():
        env_t[name] = envelope_timing(scene, cam, H, W, device, env_check[name])
        log(f"[envelope-time] {name} 1080p on {card}: {json.dumps(env_t[name])}")
    log(f"[envelope-time] after timing: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    clock("5f", run_start)
    # -- 5f. the procedural and texture instances per stage: what each instance
    # uses, the march's lane utilisation and the measurement build's cycles per
    # stage --------------------------------------------------------------------
    scene, cam = scene_and_camera("clouds_high", "avatar", device)
    instances = gen_instances(mk.frame_constants(*frame_inputs(scene, cam)[0], H, W))
    log(f"[stages] the procedural instances on {card}: {json.dumps(instances)}")
    stage_frames = {}
    for label in ("clouds_high/avatar", "clouds_high/interior", "clouds/avatar"):
        scene, cam = scene_and_camera(*label.split("/"), device)
        stage_frames[label] = (scene, cam, scene_plan(scene, cam, H), H, W)
    for pose in ("avatar", "sunward"):
        scene, cam, plan, _ = sky_runs[f"clouds_high/{pose}"]
        stage_frames[f"clouds_high/{pose} with the sky"] = (scene, cam, plan, H, W)
    kind, scene, cam, ch, cw, plan = cells["5"]
    stage_frames["cell 5"] = (scene, cam, plan, ch, cw)
    for name, (scene, cam, _) in env_runs.items():
        stage_frames[name] = (scene, cam, scene_plan(scene, cam, H), H, W)
    for pose, (scene, cam, _) in tex_runs.items():
        stage_frames[f"clouds_high texture/{pose}"] = (scene, cam, scene_plan(scene, cam, H), H, W)
    scene, cam, plan, _ = sky_runs["everything-on/avatar"]
    stage_frames["everything-on/avatar with the sky"] = (scene, cam, plan, H, W)
    stages = {}
    for label, (scene, cam, plan, fh, fw) in stage_frames.items():
        stages[label] = stage_split(plan, scene, cam, fh, fw, device, measure_path)
        log(f"[stages] {label} {fh}x{fw} on {card}: {json.dumps(stages[label])}")
        check_parent_work(label, [x["work"] for x in stages[label]])
    check_parent_work(f"clouds_high/avatar on {FLAGSHIP_SHARDS} shards",
                      [x["work"] for x in band_flag["launches"]])
    check_parent_work(f"everything-on/avatar {SH}x{SW} on {SHARDS} shards",
                      [x["work"] for x in shard_t["everything-on"]["launches"] if x["texture"]])
    # the general texture instance: phase 4g's frames, and bench cell 6 asked
    # of it (mk.launch(general=True))
    general_frames = {name: tex_envelope_scene(changes, device, textures)
                      for name, changes in TEX_ENVELOPE_FRAMES.items()}
    general_frames["bench cell 6 through the general instance"] = scene_and_camera(
        "clouds_high", "avatar", device, textures=textures)
    for label, (scene, cam) in general_frames.items():
        stages[label] = stage_split(scene_plan(scene, cam, H), scene, cam, H, W, device,
                                    measure_path, general=True)
        log(f"[stages] {label} {H}x{W} on {card}: {json.dumps(stages[label])}")
        check_parent_work(label, [x["work"] for x in stages[label]])
    log("[stages] every cloud launch's work counts equal the previous design's")

    clock("6", run_start)
    # -- 6. the flight slice at 1080p through Scene.render_flight ----------------
    K = FLIGHT_FRAMES
    stack = fly_path(K)
    flights = {"clouds_high TAA": (None, FLIGHT_BLEND),
               "clouds_high texture TAA": (textures, FLIGHT_BLEND),
               "clouds_high": (None, None)}
    scenes, flight_err = {}, {}
    mk.counters.reset()
    taa.counters.reset()
    for label, (tx, blend) in flights.items():
        scene, _ = scene_and_camera("clouds_high", "avatar", device, textures=tx)
        cam = Camera.create(stack[0], device=device)
        before = (mk.counters.megakernel_launches, taa.counters.launches)
        out = scene.render_flight(cam, flight_times(K), H, W, cam_transforms=stack,
                                  taa_blend=blend)
        torch.cuda.synchronize()
        k1 = mk.counters.megakernel_launches - before[0]
        k3 = taa.counters.launches - before[1]
        plain = mk.counters.plain_calls + taa.counters.plain_calls
        log(f"[flight] {label} 1080p K={K}: counters K1 {k1}, K3 {k3}, plain {plain}")
        if (k1, k3, plain) != (K, K if blend else 0, 0):
            raise RuntimeError(f"{label}: the flight did not go through K1 and K3 only")
        scenes[label] = (scene, cam)
        flight_err[label] = check_flight(f"{label} 1080p", out,
                                         plain_flight(scene, cam, flight_times(K), stack, H, W,
                                                      blend))
    flight_k1 = mk.counters.megakernel_launches
    flight_tex = mk.counters.texture_launches
    flight_k3 = taa.counters.launches

    clock("7", run_start)
    # -- 7. flight timing, K3 alone, the launch floor -----------------------------
    flight_timing = {}
    for label, (tx, blend) in flights.items():
        scene, cam = scenes[label]
        best = None
        for r in range(FLIGHT_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scene.render_flight(cam, flight_times(K, 1.0 + r), H, W, cam_transforms=stack,
                                taa_blend=blend)
            t_host = time.perf_counter() - t0
            torch.cuda.synchronize()
            t_all = time.perf_counter() - t0
            if best is None or t_all < best[1]:
                best = (t_host, t_all)
        def traced(t0, scene=scene, cam=cam, blend=blend):
            return flight_trace(lambda: scene.render_flight(
                cam, flight_times(K, t0), H, W, cam_transforms=stack, taa_blend=blend))

        trace = traced(5.0)
        for retry in range(1, FLIGHT_TRACE_TRIES):
            if trace["frame_kernels"] == K * (2 if blend else 1):
                break
            # the trace missed events
            log(f"[flight-time] {label}: a trace caught {trace['frame_kernels']} of the "
                f"flight's kernels; tracing once more")
            trace = traced(5.0 + retry)
        t = {"flight_ms_per_frame": best[1] / K * 1e3, "host_ms_per_frame": best[0] / K * 1e3,
             "device_busy_ms_per_frame": trace["device_busy_ms"] / K,
             "idle_share": 1.0 - trace["device_busy_ms"] / (best[1] * 1e3),
             "frame_kernels_in_trace": trace["frame_kernels"],
             "d2h_copies": trace["d2h_copies"], "d2h_copies_in_loop": trace["d2h_copies_in_loop"]}
        flight_timing[label] = t
        log(f"[flight-time] {label} 1080p K={K} on {card}: {json.dumps(t)}")
        if trace["d2h_copies_in_loop"] or trace["frame_kernels"] != K * (2 if blend else 1):
            raise RuntimeError(f"{label}: device->host copies inside the flight's launch loop "
                               "(or a trace without the flight's kernels)")
    log(f"[flight-time] Scene.render for comparison (phase 5): clouds_high/avatar "
        f"{timings['clouds_high/avatar']['scene_ms']:.3f} ms, texture/avatar "
        f"{timings['clouds_high/texture/avatar']['scene_ms']:.3f} ms")

    # K3 alone on the flight's own second frame: its raw frame, depth and history
    scene, cam = scenes["clouds_high TAA"]
    inputs, _ = frame_inputs(scene, cam)
    resolve = taa.flight_constants(cam, stack, taa.TaaSettings(blend=FLIGHT_BLEND), H, W)[1]
    raw = mk.render_frame_plain(inputs[0], inputs[1], cam, inputs[3], H, W)
    hist = torch.rand((H, W, 3), device=device)
    hist_depth = raw["linear_depth"].clone()
    taa_out, taa_depth = torch.empty_like(hist), torch.empty_like(hist_depth)

    def k3(i):
        taa.launch(resolve, raw["color"], raw["linear_depth"], hist, hist_depth, taa_out,
                   taa_depth)

    def k3_plain(i):
        taa.resolve_plain(resolve, raw["color"], raw["linear_depth"], hist, hist_depth)

    taa_t = {"kernel_ms": time_cuda(k3, KERNEL_FRAMES),
             "device_ms": kernel_trace(lambda: [k3(i) for i in range(KERNEL_FRAMES)],
                                       "taa_kernel")["device_us"] / 1e3,
             "plain_ms": time_cuda(k3_plain, 3), "instance": taa.info()}
    t_bytes = H * W * BYTES_TAA_PIXEL / PEAK_BYTES * 1e3
    t_ops = ops_time_ms(H * W * OPS_TAA_PIXEL)
    taa_t.update(bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
    log(f"[taa-time] K3 alone 1080p on {card}: {json.dumps(taa_t)}")

    fill_t, route = fill_phase(device, card)
    fill_launches, fill_err = fill_t["launches"], fill_t["max_abs_err"]
    # T1: K2 alone at 1080p-sized batches (here, after the run's first
    # torch.profiler trace in phase 4e, as every trace of the run comes)
    k2_t = k2_timing(device)
    for kind, t in k2_t.items():
        log(f"[k2-time] K2 alone ({kind}), 1080p-sized batches on {card}: {json.dumps(t)}")
    log(f"[flight-time] after timing: {smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    clock("7c", run_start)
    # -- 7c. T1 on the demo frame's own batches: the band-fidelity tool --------------
    band_t = band_fidelity_phase(device, card, textures)

    clock("8", run_start)
    # -- 8. the CLI and the Godot scene importer at 1080p, large worlds ------------
    with tempfile.TemporaryDirectory() as tmp:
        imported = import_phase(device, card, tmp)
        clock("8 large worlds", run_start)
        large = large_world_phase(device, card)
        clock("8 cli", run_start)
        cli_out = cli_phase(device, card, tmp)

    clock("9", run_start)
    # -- 9. inverse rendering: the CLI's fit, gradients, the fitted frame
    # through K1, the sharded step, the 1080p step ------------------------------------
    fit_out = fit_phase(device, card)
    log(f"[fit] summary on {card}: " + json.dumps({
        "cli_ms_per_step": fit_out["cli"]["profile"]["ms_per_step"],
        "cli_idle_share": fit_out["cli"]["profile"]["idle_share"],
        "cli_peak_bytes": fit_out["cli"]["profile"]["peak_bytes"],
        "check_size_ms_per_step": fit_out["gradients"]["profile"]["ms_per_step"],
        "check_size_idle_share": fit_out["gradients"]["profile"]["idle_share"],
        "check_size_peak_bytes": fit_out["gradients"]["profile"]["peak_bytes"],
        "full_size": fit_out["full_size"], "seconds": fit_out["seconds"]}))

    # 7b: T2 (measured before phase 3; every bound above divides by it)
    log(f"[peak] T2 on {card}: fp32 {peak['fp32_flops'] / 1e12:.3f} TFLOP/s "
        f"({peak['fp32_clock_ratio']:.4f} of {peak['clock_fp32_flops'] / 1e12:.3f} at the sampled "
        f"clock, {peak['fp32_spec_ratio']:.4f} of {SPEC_FP32 / 1e12:.0f}), expf "
        f"{peak['exp_per_s'] / 1e12:.3f} T/s, __expf {peak['fast_exp_per_s'] / 1e12:.3f} T/s, "
        f"INT32 {peak['int32_per_s'] / 1e12:.3f} Tinstr/s "
        f"({peak['int32_clock_ratio']:.4f} at the sampled clock); plain chains at the timed "
        f"iteration counts (2048 distinct threads) {json.dumps(peak['plain_ms'])} ms; "
        f"clocks {peak['clocks_under_load']}")

    flagship, tex_flagship = "clouds_high/avatar", "clouds_high/texture/avatar"
    band7 = next(x for x in cell_t["7"]["launches"] if x["kind"] != "opaque")
    if not all(clear_launches.values()):
        raise RuntimeError(f"the main path launched no cloud-free instance: {clear_launches}")
    clock("end", run_start)
    log(json.dumps({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "godot_atmosphere_shader_tpu_torch/csrc/megakernel.cu",
        "replaces": "godot_atmosphere_shader_tpu/ops/pallas/megakernel.py:171",
        "launches": launches,
        "flight_launches": flight_k1 - flight_tex,
        "bench_cell_launches": cell_launches,
        "cell5_ms": cell_t["5"]["frame_kernel_ms"],
        "cell5_launches_per_frame": cell_t["5"]["launches_per_frame"],
        "cell5_bound_ms": cell_t["5"]["frame_bound_ms"],
        "scene_max_abs_err": scene_err,
        "max_abs_err": max_err,
        "instances": instances,
        "lane_utilisation": stages[flagship][0]["lane_utilisation"],
        "stage_share": stages[flagship][0]["stage_share"],
        "per_scene": {
            "note": ("sized per scene: the first 8 spheres, 4 boxes and 8 octaves (and warp "
                     "octaves) in the launch struct, the rest in the scene's float buffer on "
                     "the card that it points to; a launch that reads it takes each kernel's "
                     "EXT instance"),
            "imported_1080p": {k: {"ms": v["kernel_ms"], "device_ms": v["device_ms"],
                                   "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
                                   "scene_ms": v["scene_ms"], "idle_share": v["scene_idle_share"],
                                   "plain_ms": v["plain_ms"], "max_abs_err": v["check"]["max"],
                                   "launches": v["counters"]["K1"]}
                               for k, v in imported.items()},
            "geometry_cases_max_abs_err": max(v["max"] for k, v in geometry.items()
                                              if k != "conditioning"),
            "large_world": {k: large[k] for k in ("earth_max", "earth_rebased_mean",
                                                  "earth_raw_mean", "flagship_max",
                                                  "flight_max", "earth_time",
                                                  "flagship_time")},
            "lut": {k: lut[k] for k in ("bake_ms", "bake_rel_err", "plain_ms")},
            "cli": cli_out,
        },
        "gpu_gate": [{"check": f"{r['variant']}/{r['pose']}", "pass": r["pass"],
                      "tolerance": r.get("tolerance")} for r in gate],
        "ms": timings[flagship]["kernel_ms"],
        "plain_ms": timings[flagship]["plain_ms"],
        "bound_ms": bounds[flagship]["bound_ms"],
        "bound_by": bounds[flagship]["bound_by"],
        "library_ms": None,
    }, {
        "name": "megakernel_clear",
        "slice": ("K1's cloud-free instance: a layer without clouds and the opaque-only pass "
                  "(ms: cell 7's gas-giant band at 1080p, 64 steps; plain_ms: cell 7's plain "
                  "chain; launches: phases 4c, 4d, 4e; max_abs_err: cells 1, 2 and 7 against "
                  "their plain chains)"),
        "route": "cuda",
        "source": "godot_atmosphere_shader_tpu_torch/csrc/megakernel.cu",
        "replaces": "godot_atmosphere_shader_tpu/ops/pallas/megakernel.py:171",
        "launches": sum(clear_launches.values()),
        "launches_by_phase": clear_launches,
        "max_abs_err": clear_err,
        "instance": band7["instance"],
        "ms": band7["ms"],
        "device_ms": band7["device_ms"],
        "plain_ms": cell_t["7"]["plain_ms"],
        "bound_ms": band7["bound_ms"],
        "bound_by": band7["bound_by"],
        "work": band7["work"],
        "gas_giant_limb": {"max_abs": gas_giant["max_abs"], "kernel": gas_giant["kernel"]},
        "library_ms": None,
    }, {
        "name": "megakernel_tex",
        "route": "cuda",
        "source": "godot_atmosphere_shader_tpu_torch/csrc/megakernel.cu",
        "replaces": ("godot_atmosphere_shader_tpu/ops/pallas/texsample.py:348, "
                     "godot_atmosphere_shader_tpu/ops/pallas/texsample.py:544 (inside "
                     "godot_atmosphere_shader_tpu/ops/pallas/megakernel.py:171)"),
        "launches": tex_launches,
        "flight_launches": flight_tex,
        "max_abs_err": tex_err,
        "k2_alone_max_abs_err": k2_err,
        "instances": {f"G={x['group']}": {k: x[k] for k in mk.TEX_INFO} for x in (
            stages[f"clouds_high texture/{pose}"][0] for pose in TEXTURE_POSES)},
        "stage_share": stages["clouds_high texture/avatar"][0]["stage_share"],
        "ms": timings[tex_flagship]["kernel_ms"],
        "plain_ms": timings[tex_flagship]["plain_ms"],
        "bound_ms": bounds[tex_flagship]["bound_ms"],
        "bound_by": bounds[tex_flagship]["bound_by"],
        "library_ms": None,
    }, {
        "name": "megakernel_tex_general",
        "slice": ("K1 slice (i): the texture envelope, megakernel_tex_general: a baked field "
                  "beside a procedural one, full quality, any knot count, knot group and LOD "
                  f"group (ms, bound_ms, plain_ms: the {TEX_REF_FRAME} at 1080p, G = 1, its "
                  "two launches: the tile pass and the frame; frames: each 4g frame's)"),
        "route": "cuda",
        "source": "godot_atmosphere_shader_tpu_torch/csrc/megakernel.cu",
        "replaces": ("godot_atmosphere_shader_tpu/ops/pallas/megakernel.py:171 (the texture "
                     "envelope of _check_config, :468-496, through :636), with "
                     "godot_atmosphere_shader_tpu/ops/pallas/texsample.py:348 and :544 "
                     "inside"),
        "launches": tex_env["launches"],
        "max_abs_err": max(v["check"]["max"] for v in tex_env["frames"].values()),
        "small_max_abs_err": max(v["max"] for v in tex_small.values()),
        "small_cases": tex_small,
        "instance": tex_env["frames"][TEX_REF_FRAME]["instance"],
        "ms": tex_env["frames"][TEX_REF_FRAME]["kernel_ms"],
        "device_ms": tex_env["frames"][TEX_REF_FRAME]["device_ms"],
        "plain_ms": tex_env["frames"][TEX_REF_FRAME]["plain_ms"],
        "bound_ms": tex_env["frames"][TEX_REF_FRAME]["bound_ms"],
        "bound_by": tex_env["frames"][TEX_REF_FRAME]["bound_by"],
        "frames": {k: {"ms": v["kernel_ms"], "device_ms": v["device_ms"],
                       "frame_device_ms": v["frame_device_ms"],
                       "choice_device_ms": v["choice_device_ms"], "bound_ms": v["bound_ms"],
                       "frame_bound_ms": v["frame_bound_ms"],
                       "choice_bound_ms": v["choice_bound_ms"], "bound_by": v["bound_by"],
                       "plain_ms": v["plain_ms"], "scene_ms": v["scene_ms"],
                       "idle_share": v["scene_idle_share"], "tolerance": v["tolerance"],
                       "instance": v["instance"]}
                   for k, v in tex_env["frames"].items()},
        "stage_cycles": {k: [x["stage_cycles"] for x in stages[k]] for k in general_frames},
        "bench_cell_6_both_instances": both,
        "library_ms": None,
    }, {
        "name": "tex_choice",
        "slice": ("the general texture instance's tile pass (tex_choice_kernel), the first of "
                  "its two launches: every pixel's shading, and the sky's and each knot batch's "
                  "level and mode over every coverage group of a 32x128 tile (ms: its device "
                  f"time in the {TEX_REF_FRAME}'s launches at 1080p, torch.profiler: it runs "
                  "only before the frame; device_ms: each 4g frame's; bound_ms: the work it "
                  "runs; plain_ms: its plain version, the plain chain's own choices; "
                  "max_abs_err: the largest |delta| of (mode, level) over phase 3h's cases and "
                  "phase 4g's frames, each the buffer of a launch)"),
        "route": "cuda",
        "source": "godot_atmosphere_shader_tpu_torch/csrc/megakernel.cu",
        "replaces": ("godot_atmosphere_shader_tpu/ops/pallas/texsample.py:348 and :544 (the "
                     "batch choice of sample_tex3d and sample_latlong on a tile's knots, inside "
                     "godot_atmosphere_shader_tpu/ops/pallas/megakernel.py:636)"),
        "launches": tex_env["choice_launches"],
        "max_abs_err": max(v["choice"]["max_abs"] for v in tex_env["frames"].values()),
        "slots_compared": (sum(v["choice"]["slots"] for v in tex_env["frames"].values())
                           + sum(v["choice_slots"] for v in tex_small.values())),
        "ms": tex_env["frames"][TEX_REF_FRAME]["choice_device_ms"],
        "device_ms": {k: v["choice_device_ms"] for k, v in tex_env["frames"].items()},
        "plain_ms": tex_env["frames"][TEX_REF_FRAME]["choice"]["plain_ms"],
        "bound_ms": tex_env["frames"][TEX_REF_FRAME]["choice_bound_ms"],
        "bound_by": tex_env["frames"][TEX_REF_FRAME]["choice_bound_by"],
        "library_ms": None,
    }, {
        "name": "megakernel_sky",
        "slice": "K1 slice (f): the panorama sky, K2's lat-long sampler on three channel "
                 "pyramids, one choice per 32x128 tile (ms: the opaque-only pass with the "
                 "sky at 1080p)",
        "route": "cuda",
        "source": "godot_atmosphere_shader_tpu_torch/csrc/megakernel.cu",
        "replaces": ("godot_atmosphere_shader_tpu/ops/pallas/texsample.py:544 (sample_latlong "
                     "as the sky, godot_atmosphere_shader_tpu/ops/pallas/megakernel.py:212) "
                     "inside godot_atmosphere_shader_tpu/ops/pallas/megakernel.py:636"),
        "launches": sky_counts[1],
        "max_abs_err": sky_frame_err,
        "small_max_abs_err": sky_err,
        "allon_signature": allon_sig,
        "ms": opaque_sky["ms"],
        "no_sky_ms": opaque_sky["no_sky_ms"],
        "plain_ms": opaque_sky["plain_ms"],
        "bound_ms": opaque_sky["bound_ms"],
        "bound_by": opaque_sky["bound_by"],
        "sky_cost_ms": sky_cost_ms,
        "frame_kernel_ms": {k: v["frame_kernel_ms"] for k, v in sky_t.items()},
        "glow_ms": glow_t["ms"],
        "glow_max_abs_err": glow_err,
        "library_ms": None,
    }, {
        "name": "sky_choice",
        "slice": ("K1 slice (f): the sky's per-tile level and mode for the procedural "
                  "instance and the opaque-only pass (ms: the everything-on/space "
                  "opaque-only pass's tiles at 1080p)"),
        "route": "cuda",
        "source": "godot_atmosphere_shader_tpu_torch/csrc/megakernel.cu",
        "replaces": ("godot_atmosphere_shader_tpu/ops/pallas/texsample.py:544 (sample_latlong's "
                     "per-block choice, as the sky inside "
                     "godot_atmosphere_shader_tpu/ops/pallas/megakernel.py:636)"),
        "launches": sky_counts[2],
        "max_abs_err": choice_err,
        "ms": choice_t["everything-on/space"]["ms"],
        "device_ms": {k: v["device_ms"] for k, v in choice_t.items()},
        "plain_ms": choice_t["everything-on/space"]["plain_ms"],
        "bound_ms": choice_t["everything-on/space"]["bound_ms"],
        "bound_by": choice_t["everything-on/space"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "taa",
        "route": "cuda",
        "source": "godot_atmosphere_shader_tpu_torch/csrc/taa.cu",
        "replaces": "godot_atmosphere_shader_tpu/ops/pallas/taa.py:345",
        "launches": flight_k3,
        "max_abs_err": taa_err,
        "validity_flip_share": taa_flips,
        "flight_max_abs_err": max(flight_err.values()),
        "instance": taa_t["instance"],
        "device_ms": taa_t["device_ms"],
        "ms": taa_t["kernel_ms"],
        "plain_ms": taa_t["plain_ms"],
        "bound_ms": taa_t["bound_ms"],
        "bound_by": taa_t["bound_by"],
        "library_ms": None,
    }, {
        "name": "megakernel_band",
        "slice": ("K1 slice (g): a row shard of the frame, layer 0 fusing the opaque pass and "
                  "the sky over the shard's rows, later layers chained over them (ms: "
                  f"clouds_high/avatar at 1080p on {FLAGSHIP_SHARDS} shards, both shards' "
                  "launches in sequence)"),
        "route": "cuda",
        "source": "godot_atmosphere_shader_tpu_torch/csrc/megakernel.cu",
        "replaces": ("godot_atmosphere_shader_tpu/ops/pallas/megakernel.py:655 "
                     "(render_band_pallas), godot_atmosphere_shader_tpu/ops/pallas/"
                     "megakernel.py:686 (render_scene_band_pallas), through "
                     "godot_atmosphere_shader_tpu/ops/pallas/megakernel.py:636"),
        "launches": band_k1,
        "max_abs_err": shard_err,
        "vs_single_card_max": {k: v["max"] for k, v in shard_cmp.items() if isinstance(v, dict)},
        "ms": band_flag["frame_kernel_ms"],
        "per_shard_ms": [x["ms"] for x in band_flag["launches"]],
        "single_card_ms": band_flag["single_card_kernel_ms"],
        "plain_ms": band_flag["plain_ms"],
        "bound_ms": band_flag["frame_bound_ms"],
        "bound_by": max(band_flag["launches"], key=lambda x: x["bound_ms"])["bound_by"],
        "everything_on_ms": shard_t["everything-on"]["frame_kernel_ms"],
        "everything_on_single_card_ms": shard_t["everything-on"]["single_card"]["frame_kernel_ms"],
        "nccl_world_size_1": nccl,
        "library_ms": None,
    }, {
        "name": "taa_band",
        "slice": (f"K3 band mode: a shard's rows against its history band (ms: one "
                  f"{SH // SHARDS}-row shard of {SH}x{SW}, halo {TAA_HALO})"),
        "route": "cuda",
        "source": "godot_atmosphere_shader_tpu_torch/csrc/taa.cu",
        "replaces": ("godot_atmosphere_shader_tpu/ops/pallas/taa.py:345 (band mode, "
                     "godot_atmosphere_shader_tpu/ops/pallas/taa.py:65-134)"),
        "launches": band_k3,
        "max_abs_err": taa_band["max_abs_err"],
        "flight_max_abs_err": shard_flight_err,
        "device_ms": taa_band["device_ms"],
        "ms": taa_band["ms"],
        "plain_ms": taa_band["plain_ms"],
        "bound_ms": taa_band["bound_ms"],
        "bound_by": taa_band["bound_by"],
        "sharded_flight": shard_flight_t,
        "library_ms": None,
    }, {
        "name": "megakernel_envelope",
        "slice": ("K1 slice (h): the procedural instance, every noise basis, per-step "
                  "fields, the detail field, any knot count and LOD group (ms, bound_ms, "
                  "plain_ms: the cellular tier at 1080p; frames: each 4f frame's, plain_ms "
                  "the whole plain frame)"),
        "route": "cuda",
        "source": "godot_atmosphere_shader_tpu_torch/csrc/megakernel.cu",
        "replaces": ("godot_atmosphere_shader_tpu/ops/pallas/megakernel.py:171 (the procedural "
                     "envelope of _check_config, :468-496, through :636)"),
        "launches": env_counts[1],
        "max_abs_err": max(v["max"] for v in env_check.values()),
        "small_max_abs_err": max(v["max"] for v in envelope_small.values()),
        "ms": env_t["cellular_tier"]["kernel_ms"],
        "plain_ms": env_t["cellular_tier"]["plain_ms"],
        "bound_ms": env_t["cellular_tier"]["bound_ms"],
        "bound_by": env_t["cellular_tier"]["bound_by"],
        "frames": {k: {"ms": v["kernel_ms"], "bound_ms": v["bound_ms"],
                       "bound_by": v["bound_by"], "plain_ms": v["plain_ms"],
                       "scene_ms": v["scene_ms"], "idle_share": v["scene_idle_share"]}
                   for k, v in env_t.items()},
        "library_ms": None,
    }, {
        "name": "fp32_peak",
        "slice": ("T2: register-resident fma, expf, __expf and uint32 multiply-add chains; "
                  "ms: the fma launch, bound_ms: its operations over the fp32 ceiling every "
                  "bound divides by, plain_ms: the plain fma chains at the same iteration "
                  "count over the 2048 distinct threads (the kernel's output repeats them)"),
        "route": "cuda",
        "source": "godot_atmosphere_shader_tpu_torch/csrc/probes.cu",
        "replaces": "tools/vpu_peak.py:86",
        "launches": peak["launches"],
        "max_abs_err": peak["max_abs_err"],
        "ms": peak["ms"]["fma"],
        "plain_ms": peak["plain_ms"]["fma"],
        "bound_ms": peak["bound_ms"],
        "bound_by": "operations",
        "fp32_tflops": peak["fp32_flops"] / 1e12,
        "exp_per_s": peak["exp_per_s"],
        "fast_exp_per_s": peak["fast_exp_per_s"],
        "int32_per_s": peak["int32_per_s"],
        "fp32_spec_ratio": peak["fp32_spec_ratio"],
        "fp32_clock_ratio": peak["fp32_clock_ratio"],
        "fp32_ceiling_tflops": PEAK["fp32"] / 1e12,
        "clocks_under_load": peak["clocks_under_load"],
        "library_ms": None,
    }, {
        "name": "texsample",
        "slice": ("T1: K2 alone (texsample_kernel through mk.sample_batches) on 1530 batches "
                  "x 8192 samples; ms, device_ms, bound_ms, plain_ms: the 3D texture's banded "
                  "case; latlong: the lat-long map's; band_fidelity: the band-fidelity tool on "
                  "the demo frame's 1530 batches at the interior pose (phase 7c; launches "
                  "counts its K2 launches too); the GPU gate's banded sampler ran in phase 3k"),
        "route": "cuda",
        "source": "godot_atmosphere_shader_tpu_torch/csrc/megakernel.cu",
        "replaces": ("tests/test_texsample.py:40, tools/tpu_checks.py:138, "
                     "tools/measure_band_fidelity.py:181 (the harnesses around "
                     "godot_atmosphere_shader_tpu/ops/pallas/texsample.py:348 and :544)"),
        "launches": (k2_t["tex3d"]["launches"] + k2_t["latlong"]["launches"]
                     + band_t["launches"]),
        "band_fidelity": {k: band_t[k] for k in ("launches", "windowed", "banded",
                                                  "k2_same_choice", "k2_full_batches", "timing")}
        | {"field_err": {k: {x: band_t[f"field_err_{k}"].get(x) for x in (
            "engaged_batches", "windowed", "banded", "k2_vs_plain_max")}
            for k in ("first", "every")}},
        "max_abs_err": max(k2_t["tex3d"]["max_abs_err"], k2_t["latlong"]["max_abs_err"],
                           band_t["field_err_every"]["k2_vs_plain_max"]),
        "ms": k2_t["tex3d"]["ms"],
        "device_ms": k2_t["tex3d"]["device_ms"],
        "host_ms": k2_t["tex3d"]["host_ms"],
        "plain_ms": k2_t["tex3d"]["plain_ms"],
        "bound_ms": k2_t["tex3d"]["bound_ms"],
        "bound_by": k2_t["tex3d"]["bound_by"],
        "latlong": {k: k2_t["latlong"][k] for k in ("ms", "device_ms", "host_ms", "plain_ms",
                                                      "bound_ms", "bound_by", "max_abs_err")},
        "library_ms": None,
    }, {
        "name": "launch_floor",
        "route": "cuda",
        "source": "godot_atmosphere_shader_tpu_torch/csrc/probes.cu",
        "replaces": "tools/profile_small.py:101",
        "launches": fill_launches,
        "max_abs_err": fill_err,
        "ms": fill_t["kernel_ms"],
        "device_ms": fill_t["device_us"] / 1e3,
        "graph_ms": fill_t["graph_kernel_ms"],
        "plain_ms": fill_t["plain_ms"],
        "bound_ms": fill_t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": fill_t["library_ms"],
        "library_graph_ms": fill_t["graph_library_ms"],
        "route_us": {k: route[k] for k in ("old_route", "new_route", "launch_only")},
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
