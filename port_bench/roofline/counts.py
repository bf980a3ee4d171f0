"""Frozen per-unit operation and byte counts of the port's kernels, counted
by hand from ``csrc/megakernel.cu`` and ``csrc/taa.cu`` and copied from the
repo's ``chip_smoke.py`` (its ``OPS_*``, ``BASIS_OPS``, ``FRACTAL_OPS``,
``WARP_OPS``, ``BYTES_*`` and the arithmetic of ``noise_ops``,
``atmosphere_ops`` and ``work_ops``).  The units a frame needs come from
:mod:`port_bench.roofline.k1_work`, never from the kernels' counters."""

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
