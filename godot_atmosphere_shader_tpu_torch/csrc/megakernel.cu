// Fused frame megakernel for NVIDIA Hopper (sm_90a): opaque pass (with a
// starfield or the panorama sky), v1 or v2 atmosphere (v2 with analytic sun
// optical depth), cloud march (cheap or sun-marched light) and composite, in
// one launch per atmosphere layer.
// Four instances: the procedural instance (megakernel_gen: every
// procedural cloud config, below), the cloud-free instance (megakernel_clear:
// cloud-free layers and the opaque-only pass) and texture mode, whose baked
// cloud fields are sampled through mip pyramids by the K2 device functions
// below: the fixed instance (megakernel_tex: the demo's profile) and the
// general one (megakernel_tex_general: a baked field beside a procedural
// one, full quality, any knot count, knot group and LOD group).
//
// Replaces the TPU Pallas kernels
//   godot_atmosphere_shader_tpu/ops/pallas/megakernel.py::_make_kernel
// (launched by _render_pallas_jit, pallas_call at megakernel.py:636): a
// layer over the fused opaque pass or over the layers below (the far->near
// chain of _chain_layers), on the whole frame or on a far-mode row band,
// or the opaque pass alone; and, inside it,
//   godot_atmosphere_shader_tpu/ops/pallas/texsample.py::sample_tex3d (:348)
//   and ::sample_latlong (:544), with their _window_lookup (:275).
// Their plain PyTorch versions are
//   godot_atmosphere_shader_tpu_torch/render/renderer.py::render_frame and
//   godot_atmosphere_shader_tpu_torch/ops/kernels/texsample.py,
// and every formula below follows that code's operation order.
//
// What bounds it on an H100: fp32 and SFU throughput (expf, sqrtf, floorf
// and the uint32 lattice hashes of the cloud noise) plus warp divergence at
// shell silhouettes and culled pixels.  Not memory: a 1080p frame writes
// 16 bytes per pixel (about 33 MB, ~10 us at 3.35 TB/s) and reads only the
// 256 KB blue-noise tile.  What the design does about it:
//   * one thread per column and per group of cloud_lod * coverage_lod rows,
//     so the coarse cloud inputs, the coverage knots and the march are
//     computed once per group without any cross-thread exchange;
//   * the knots of a coverage group live in shared memory, knot-major
//     (below);
//   * the conservative density-bound cull exits before the march per
//     coarse pixel (output-equivalent: a culled pixel marches to exact
//     zeros), as does every pixel whose ray misses the shell;
//   * no intermediate goes to device memory (the procedural instance keeps
//     a row's background in its own output pixel until the blend); per-row
//     state lives in registers or shared memory.
//
// Texture mode (K2).  The TPU has no per-lane gather, so its samplers scan
// a VMEM window row by row with lane gathers; the window machinery is why a
// batch of positions must share one mip level and mode.  Hopper gathers
// directly, so here every lookup is one __ldg from the flat pyramid in
// global memory (1.2 MiB shape + 0.7 MiB lat-long, L2-resident), and only
// the batch semantics are kept, because they decide the result: a batch is
// one 32 x 128 TPU tile's knot positions of one knot group (up to 8 knots),
// its level and mode come from a block-wide min/max of the wrapped
// coordinates, and the samples are trilinear (bilinear) at that level or
// nearest from the floor level.  What bounds the texture path: the same
// arithmetic as above minus the procedural noise, plus 5 block-wide
// reductions (__syncthreads) per tile and ~26 x 8 dependent L2 loads per
// coverage group.  What the design does about it: one block per tile
// (128 x 32 / G threads, 1024 at the avatar pose), knots evaluated once per
// coverage group into dynamic shared memory (26 floats per thread, knot-
// major: no bank conflicts in the march), and the tile's visibility gate
// skips knots and march for tiles with no visible pixel, as the TPU does.
// Sampler arithmetic is uncontracted (__fmul_rn/__fadd_rn), so a batch's
// level choice and weights follow the plain version bit for bit given the
// same positions.
//
// Flight mode adds two things the TAA resolve needs (megakernel.py:385-390,
// :348-349, :402-403): per-frame temporal jitter, and an optional output of
// the opaque pass's linear depth (before the sphere-depth blend), for the
// reprojection.
//
// Scenes of several layers (megakernel.py:770-849) are one launch per
// layer, far to near, on one stream:
//   * bands: a far-mode layer's grid covers its rows [row0, row0 + rows)
//     only; ray directions still use the full frame height, the jitter is
//     read at the global row (the blue-noise tiling is 256-periodic, so
//     this equals the TPU's slice of the full-frame jitter plane), and the
//     outputs go straight into the frame's rows;
//   * chaining (with_background): a later layer reads the composite so far
//     and the carried linear depth from the frame planes instead of running
//     the opaque pass, composites over it in place and writes
//     alpha = max(alpha below, its own).  In place, each pixel is read and
//     written by the one thread that owns it, and through one pointer per
//     plane (color, alpha, depth are each passed once), so no two pointers
//     alias and the __restrict__ qualifiers stay valid; no ping-pong buffer
//     and none of the TPU's slice/update copies (megakernel.py:831-846) is
//     needed;
//   * the opaque-only pass (with_atmosphere = 0, one row per thread): the
//     base frame of a chain whose layer 0 is banded: background color,
//     alpha 0 and linear depth.
// The v1 model is a run-time field (atmosphere_v1 beside atmosphere_v2),
// and so is raymarched lighting (a 6-step sun march per cloud step, kept
// rolled).
//
// The cloud-free instance (megakernel_clear: a layer without clouds, and
// the opaque-only pass): one thread per pixel in blocks of 128 columns.
// What bounds it on an H100: instruction issue in atmosphere_v2's steps
// (each step's sun optical depth is a chord with three square roots and a
// division, and 8 Gauss-Legendre nodes per smooth segment, each a
// correctly rounded square root with its range check: a step with both
// segments is 622 instructions, 19 MUFU.RSQ among them, in cuobjdump's
// listing; the gas giant runs 64 steps).  What the design does about it:
// optical_depth_analytic evaluates only the chord's non-empty smooth
// segment where the sun ray does not cross the ground ahead of the sample
// (almost every sample: the plain version integrates the empty one to an
// exact +0), which keeps the frame bit for bit; the work slot od_segments
// counts the segments evaluated, for the bound.  On an H100 at 700 W the gas
// giant's 576-row band at 1080p takes 0.289 ms against 0.429 before (23 % of
// its 0.066 ms bound), and the shared atmosphere speeds the texture frames
// by 8-10 % and the procedural ones by 3-6 % (PERF.md; compare_megakernel.py).
// Blocks of 2 or 4 rows and registers capped for 10 or 12 blocks per SM
// were measured and are slower (in git history at 394a1ac); the step loop is
// issue-bound, so splitting a pixel's steps across lanes has nothing to
// hide.
//
// The procedural instance (megakernel_gen<C, EXT>, K1 slice (h); EXT: the
// launch reads the scene's buffer, scene_buffer) takes every
// procedural config the TPU kernel renders (its body is the shared XLA
// shading code, so _check_config, megakernel.py:468-496, is the envelope):
// every noise basis (value, perlin, simplex, simplex-smooth, the 27-cell
// cellular with its three returns, the 8-cell cellular_fast), every
// fractal (ping-pong, weighted_strength), coverage and shape per step or
// from any number of knots, full-quality density (the detail field, the
// shape field at pos * 15 + time * 0.01, per step or from its knots), and
// LOD groups of up to the 32-row tile.  What bounds it: the noise and the
// march's per-step arithmetic (accurate expf, sqrtf and divisions), fp32
// and, for the cellular bases, INT32 (each of the 27 cells is three uint32
// avalanches; Hopper's INT32 lanes are half its FP32 lanes); the march
// takes 60-90 % of a frame's cycles, the knots 5-20 %, the coarse pass
// the rest but on frames where little marches (cycles per stage from the
// measurement build, -DMK_STAGE_CLOCKS, on an H100).  The march's lanes
// are not the limit: a warp's lanes march 0.98 of its steps on the 1080p
// frames (lists of the marching coarse pixels, per block or per warp,
// measured slower there).  What the design does about it:
//   * one instance per C, the coarse pixels a thread owns: its state is a
//     visibility bitmask and a few scalars in registers, its march inputs
//     in shared memory; no stack at C <= 16 (a design that sized per-row
//     arrays for 32 rows kept a 1,600 B stack);
//   * each row shaded once: its atmosphere kept in shared memory (the row
//     cache) and its background in the color plane until the blend; two
//     opaque passes only where the knots leave the cache no room;
//   * the fields of the march's steps and sun samples inlined (march_field),
//     the knots' evaluations one called copy (field);
//   * the knots in dynamic shared memory, knot-major with a stride of the
//     block (conflict-free, any count); hat-sum knots read the same two live
//     knots as dynamic ones (the other terms are exact zeros);
//   * 128 registers for 4 blocks of 4 warps per SM: capped for 5 or 6
//     blocks it spills, and frames with little march or a sun march slow.
// On an H100 at 700 W the 1080p demo frame (clouds_high at the avatar pose)
// takes 2.08 ms against a 0.82 ms bound from its operations, 10 % less than
// the design it replaces (compare_megakernel.py; PERF.md).
// The full-quality frame is ill-conditioned: the detail field turns one
// ulp of a march position into ~1e-3 of a cloud pixel; so are shape knots
// over a coverage group of 32 rows, whose knots lie along a mean span up to
// ~1e5 units long: one ulp of one pixel's span moves a column of 32 pixels.
//
// The fixed texture instance (megakernel_tex<K, KS, G>, G = cloud_lod *
// coverage_lod = 4 or 8 rows per thread, both fields baked, K = 8 coverage
// and KS = 16 shape knots, low quality; any knot group and pyramid depth):
// the same per-pixel arithmetic
// minus the noise, each coverage group's 26 knots sampled from the
// L2-resident pyramids in batches whose level and mode come from the whole
// 32 x 128 tile.  What bounds it on an H100: the coarse pass (the opaque
// pass and the per-pixel atmosphere, v2: 8 steps of one or two segments of 8
// quadrature nodes, IEEE sqrtf and expf) and the march, 0.39 and 0.37 of its
// warp-cycles at the avatar pose (G = 4), the knots with their ten barriers 0.21
// (cycles per stage from the measurement build).  One CTA per tile keeps a
// batch's choice inside the block.  Its registers are sized for 1024
// resident threads per SM (MK_TEX_SM_THREADS, 64 registers): one tile of
// 1024 threads per SM at G = 4 and two of 512 at G = 8, where 93 registers
// had held one (on an H100 at 700 W the interior pose's 1080p frame took
// 0.587 ms, 0.681 before, and 0.526 with the empty segments skipped; the
// avatar pose's 0.603, 0.664 before the skip, against a 0.136 ms bound;
// compare_megakernel.py, PERF.md).  Its per-row arrays
// stay in a 688 B stack: a redesign that held a thread's state in two
// bitmasks and shared memory (72 B), with two barriers per tile in place
// of ten, each coverage knot's (fu, v) computed once and the atmosphere
// after the barriers, did 2 % fewer warp-cycles but was 0.7 % slower at
// the avatar pose and 4 % slower on one wave of 256-row shards, and
// thread-block clusters of 2 and 4 CTAs per tile 1.5-14 % slower.
//
// The general texture instance (megakernel_tex_general, K1 slice (i)) takes
// every other texture config the TPU kernel renders, in two launches: a
// tile pass (tex_choice_kernel, one 512-thread block per tile) shades each
// row once and chooses each knot batch's level and mode over the tile's
// coverage groups, then the frame samples, marches and blends each group
// on megakernel_gen's blocks; described at the kernels.
//
// The panorama sky (megakernel.py:212-222, :334-336; with_sky): the launch
// that runs the opaque pass (a fused layer or the opaque-only pass) samples
// three channel lat-long pyramids for rays that miss all geometry, with
// K2's latlong_sample.  On the TPU one sample_latlong(window_rows = 32)
// call per channel covers a 32 x 128 block of rays, and that block's min
// and max of (fu, v), hit or miss, choose one level and mode for all of
// them; the choice decides the result, so it is kept.  The texture instance
// already has one block per tile: a block-wide min/max before the opaque
// pass, and so has the general one's tile pass (sky_block_choice, as the
// pre-pass below).  In the procedural instance and the opaque-only pass a block is
// 128 columns x G rows and no block sees its whole tile, so a pre-pass
// (sky_choice_kernel) writes each tile's choice first and the frame kernel
// reads it: one choice ray per pixel instead of 32 / G.  The pre-pass is
// one block of 128 x 4 threads per tile, 8 rays per thread, so that a 1080p
// frame's 510 tiles fit one wave (4 blocks per SM); the min and max go
// over the warp by shuffles, then one barrier, then the first warp reduces
// the 16 warps' partials by shuffles (the design it replaces, 128 x 8
// threads that each re-read every warp's partials after two barriers, took
// two waves: on an H100 at 700 W 0.0208 ms of device time per 1080p launch,
// now 0.0112).  Ray directions are computed uncontracted (pixel_dir), so
// the choice's rays and the sampled rays agree bit for bit.
// A sky pixel gathers 12 floats from its tile's level (L2-resident).
//
// Build (no fast math: the cloud density chain (...)*50-20 amplifies ulp
// differences and floorf in the noise flips lattice cells at knife edges),
// one object per source, linked with the other kernels' into one library
// (ops/kernels/library.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -fmad=true -c -o megakernel.o megakernel.cu
// The launchers have a plain C interface and are bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

// A scene's spheres, boxes and octaves are not limited: the first
// MK_INLINE_* of each sit in the launch struct, the rest in the scene's
// float buffer on the device that the struct points to (MegakernelParams
// geom, NoiseParams ext), laid out as below
#define MK_INLINE_SPHERES 8
#define MK_INLINE_BOXES 4
#define MK_INLINE_OCTAVES 8
// floats per sphere in the buffer: center (3), radius^2, albedo (3), unshaded
#define MK_GEOM_SPHERE 8
// floats per box: world_to_box (16, row-major), half size (3), albedo (3);
// its camera position in box space is computed per pixel, uncontracted as
// the host computes the inline boxes' box_origin
#define MK_GEOM_BOX 22
// floats per octave beyond MK_INLINE_OCTAVES: amp, warp_amp, warp_freq
#define MK_EXT_OCTAVE 3
#define MK_MAX_GROUP 8  // the fixed texture instance's rows per thread
#define MK_QUAD_POINTS 8
#define MK_KNOTS 8  // the fixed texture instance's coverage knots
// the procedural instance's dynamic shared memory, in rows of one float per
// thread of a 128-thread block (512 B): at most the 454 rows (232,448 B) a
// block may use; each coarse pixel of the group takes 6 rows of march
// inputs, each row of the group 4 rows of the row cache
#define MK_SMEM_ROWS 454
#define MK_GEN_MARCH_ROWS 6
#define MK_GEN_CACHE_ROWS 4
#define MK_SHAPE_KNOTS 16  // the fixed texture instance's shape knots
#define MK_MAX_LEVELS 16   // mip levels of a pyramid (the launch struct's arrays)
#define MK_TILE_ROWS 32    // texture mode: one block per TPU tile
#define MK_TILE_COLS 128
// the sky's pre-pass: threads per column of a tile, and rows per thread
constexpr int MK_SKY_CHOICE_THREADS_Y = 4;
constexpr int MK_SKY_CHOICE_RAYS = MK_TILE_ROWS / MK_SKY_CHOICE_THREADS_Y;
// batch modes of the texture samplers (texsample.py WINDOWED, BANDED, FLOOR)
#define MK_WINDOWED 0
#define MK_BANDED 1
#define MK_FLOOR 2
// work counter slots (megakernel.py WORK_SLOTS)
#define MK_WORK_PIXELS 0
#define MK_WORK_ATMOSPHERE 1
#define MK_WORK_KNOT_GROUPS 2
#define MK_WORK_MARCH 3
#define MK_WORK_TEX3D 4
#define MK_WORK_TEX3D_FLOOR 5
#define MK_WORK_LATLONG 6
#define MK_WORK_LATLONG_FLOOR 7
#define MK_WORK_SUN_SAMPLES 8
#define MK_WORK_V1_ATMOSPHERE 9
#define MK_WORK_OPAQUE_PIXELS 10
#define MK_WORK_SKY 11
#define MK_WORK_SKY_FLOOR 12
#define MK_WORK_COVERAGE_EVALS 13
#define MK_WORK_SHAPE_EVALS 14
#define MK_WORK_DETAIL_EVALS 15
#define MK_WORK_SHAPE_KNOTS 16
#define MK_WORK_DETAIL_KNOTS 17
// the procedural instance's march lanes: warp-steps issued and the lanes'
// steps (their ratio over 32 is the march's lane utilisation)
#define MK_WORK_MARCH_WARP_STEPS 18
#define MK_WORK_MARCH_LANE_STEPS 19
// the quadrature segments of the v2 sun optical depth that were evaluated
// (optical_depth_analytic skips an empty one)
#define MK_WORK_OD_SEGMENTS 20
#define MK_WORK_SLOTS 21
// The measurement build (-DMK_STAGE_CLOCKS) adds the procedural instance's
// cycles per stage, summed over warps, after the work slots
// (megakernel.py STAGE_SLOTS); the normal build never writes them.  The
// general texture instance's tile pass adds two: the rows' shading with
// every coverage group's coarse inputs, and the knot batches' choices.
#define MK_STAGE_COARSE 0
#define MK_STAGE_KNOTS 1
#define MK_STAGE_MARCH 2
#define MK_STAGE_BLEND 3
#define MK_STAGE_CHOICE_COARSE 4
#define MK_STAGE_CHOICE 5
#define MK_STAGES 6
#define MK_SUN_STEPS 6  // raymarched lighting's sun march

// ---------------------------------------------------------------------------
// Launch parameters.  The Python wrapper mirrors these structs field for
// field with ctypes (ops/kernels/megakernel.py: NoiseParams, MegakernelParams,
// TexParams); a test checks that both declare the same fields in the same
// order.

struct NoiseParams {
  int noise_type;     // 0 value, 1 simplex_smooth, 2 perlin, 3 simplex, 4 cellular, 5 cellular_fast
  int fractal_type;   // 0 none, 1 fbm, 2 ridged, 3 ping_pong
  int octaves;
  int seed;
  float frequency;
  float lacunarity;
  float gain;
  float ping_pong_strength;
  float weighted_strength;          // 0: the amplitudes below; else a per-sample chain
  float cellular_jitter;
  int cellular_return;              // 0 distance, 1 distance2, 2 cell_value
  float amp[MK_INLINE_OCTAVES];     // per-octave amplitude, bounding * gain^o
  int warp_enabled;
  int warp_octaves;
  float warp_amp[MK_INLINE_OCTAVES];   // warp_amplitude * warp_gain^o
  float warp_freq[MK_INLINE_OCTAVES];  // warp_frequency * warp_lacunarity^o
  float scale[3];                      // field domain scale
  // the octaves and warp octaves past the struct's (octaves and
  // warp_octaves count at most MK_INLINE_OCTAVES), MK_EXT_OCTAVE floats
  // each in the scene's buffer (NULL where there are none)
  int ext_octaves;
  int ext_warp_octaves;
  const float* ext;
};

struct MegakernelParams {
  int height;
  int width;
  // the frame rows this launch renders: [row0, row0 + rows) (a far-mode
  // band, or 0 and height)
  int row0;
  int rows;
  // camera: position, view->world rotation (row-major), ray preamble
  float cam_pos[3];
  float cam_rot[9];
  float ray_sx;
  float ray_sy;
  // the pixel's jitter is frac(blue + jitter_offset): flight mode's temporal
  // jitter, frac(time * 38.196601125) rounded on the host in f32, or 0 (the
  // blue-noise values lie in [0, 1), so then the jitter is the blue noise)
  float jitter_offset;
  // 0: the opaque-only pass (background color, alpha 0, linear depth out)
  int with_atmosphere;
  // 1: a chained layer: color, alpha and depth hold the layers below on
  // entry (no opaque pass), the composite on exit
  int with_background;
  // opaque scene
  int with_opaque;
  int n_spheres;  // at most MK_INLINE_SPHERES; ext_spheres more in the buffer
  int n_boxes;    // at most MK_INLINE_BOXES; ext_boxes more in the buffer
  float sphere_center[MK_INLINE_SPHERES * 3];
  float sphere_radius2[MK_INLINE_SPHERES];  // radius^2
  float sphere_albedo[MK_INLINE_SPHERES * 3];
  float sphere_unshaded[MK_INLINE_SPHERES];
  float box_w2b[MK_INLINE_BOXES * 16];
  float box_origin[MK_INLINE_BOXES * 3];  // camera position in box space
  float box_half[MK_INLINE_BOXES * 3];
  float box_albedo[MK_INLINE_BOXES * 3];
  float light_dir[3];
  float ambient;
  float sky_color[3];
  float star_intensity;
  // 1: misses sample the panorama sky's pyramids instead of sky_color and
  // the starfield (the launch's sky TexParams and r, g, b tables)
  int with_sky;
  // atmosphere (v2 with analytic sun optical depth, or v1)
  int model;                 // 0 v2, 1 v1
  int atmosphere_steps;
  float planet_center[3];
  float planet_radius;
  float atmosphere_height;
  float atmosphere_radius;   // R + H
  float atmosphere_radius2;  // (R + H)^2
  float planet_radius2;      // R^2
  float inv_height;          // 1 / H
  float density;
  float density2;            // density^2
  float sphere_depth_factor;
  float scatter[3];          // pow4(400 / lambda) * strength
  float ambient_color[3];
  float modulate[3];
  float sun_dir[3];          // world space
  float quad_x[MK_QUAD_POINTS];
  float quad_w[MK_QUAD_POINTS];
  // v1: the day and night color pairs (linear) and the transition scale
  float day_color0[3];
  float day_color1[3];
  float night_color0[3];
  float night_color1[3];
  float day_night_transition_scale;
  // clouds
  int clouds_enabled;
  int cloud_steps;
  int raymarched_lighting;   // 1: the sun march instead of cheap light
  int cloud_lod;
  int coverage_lod;
  int coverage_knots;
  int coverage_interp;       // 0: coverage per step and per sun sample
  int shape_interp;          // 1: shape (and detail) from shape_knots + 1 knots
  int shape_knots;
  int always_low;            // 0: full quality, the detail field
  float time;                // the detail field's offset is time * 0.01
  float cloud_bottom_radius;
  float cloud_top_radius;
  float cloud_bottom_radius2;
  float cloud_top_radius2;
  float cloud_layer;         // top - bottom
  float cloud_density_scale;
  float cloud_blend;
  float cloud_shape_invert;
  float cloud_coverage_bias;
  float cloud_shape_factor;
  float cloud_shape_scale;
  float cloud_shape_bound;   // 0.5 + 0.575 * |shape_factor|
  float cloud_detail_term;   // 0.1 in always-low mode, 0 at full quality
  float march_max_distance;
  float sun_step0;           // raymarched lighting's first step, 0.15 * layer / 6
  float coverage_rot[4];
  float world_to_model[16];
  float ro_model[3];         // camera position in model space
  float sd_model[3];         // sun direction in model space
  NoiseParams shape;
  NoiseParams coverage;
  // the spheres past the struct's (MK_GEOM_SPHERE floats each), then the
  // boxes past them (MK_GEOM_BOX each), in the scene's buffer; NULL where
  // there are none
  int ext_spheres;
  int ext_boxes;
  const float* geom;
};

// Texture mode: the two pyramids' levels (finest first) and the sampler
// settings of VariantConfig.  The panorama sky uses the lat-long fields
// (cov_*) of its own instance, with window_rows = 32.
struct TexParams {
  int shape_levels;
  int shape_size[MK_MAX_LEVELS];   // S of an S^3 level
  int shape_base[MK_MAX_LEVELS];   // first row of the level in the table
  int shape_floor;                 // TexMeta.floor_level(window_rows)
  int cov_levels;
  int cov_height[MK_MAX_LEVELS];
  int cov_width[MK_MAX_LEVELS];
  int cov_base[MK_MAX_LEVELS];
  int cov_floor;
  int window_rows;
  int band_rows;                   // 0: no banded mode
  int band_max_slices;
  int knot_group;                  // knots per batch
  int shape_knots;                 // VariantConfig.cloud_shape_knots
  int shape_source;                // MK_SRC_*: where the shape field comes from
  int cov_source;                  // MK_SRC_*: where the coverage field comes from
};

// Where a texture-mode field comes from (TexParams.shape_source,
// cov_source): knots sampled from its pyramid, knots evaluated from its
// procedural spec, or its procedural spec per step and per sun sample
constexpr int MK_SRC_PYRAMID = 0, MK_SRC_KNOTS = 1, MK_SRC_STEP = 2;

// ---------------------------------------------------------------------------
// Vector helpers (plain C++ arithmetic; the build lets the compiler contract
// a*b+c into an FMA, -fmad=true).

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 mul(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 normalize(V3 a) { return mul(a, rsqrtf(dot(a, a))); }
__device__ __forceinline__ float saturate(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }
__device__ __forceinline__ float fsign(float x) { return (float)((x > 0.0f) - (x < 0.0f)); }

__device__ __forceinline__ V3 load3(const float* p) { return v3(p[0], p[1], p[2]); }

// 3x3 linear part of a row-major 4x4 (or the 3x3 itself with stride 3)
__device__ __forceinline__ V3 xform_dir(const float* m, int stride, V3 d) {
  return v3(m[0] * d.x + m[1] * d.y + m[2] * d.z,
            m[stride] * d.x + m[stride + 1] * d.y + m[stride + 2] * d.z,
            m[2 * stride] * d.x + m[2 * stride + 1] * d.y + m[2 * stride + 2] * d.z);
}

// (t0, t1) with the reference's (1e6, 1e6) miss sentinel; hit <=> t0 != t1
__device__ __forceinline__ void ray_sphere(V3 center, float radius2, V3 ro, V3 rd,
                                           float& t0, float& t1) {
  V3 oc = sub(ro, center);
  float b = dot(oc, rd);
  V3 qc = sub(oc, mul(rd, b));
  float h = radius2 - dot(qc, qc);
  bool miss = h < 0.0f;
  float sq = sqrtf(miss ? 1.0f : fmaxf(h, 1e-12f));
  t0 = miss ? 1.0e6f : -b - sq;
  t1 = miss ? 1.0e6f : -b + sq;
}

// ---------------------------------------------------------------------------
// Lattice noise (ops/noise.py), uint32 arithmetic as in the JAX package.

__device__ __forceinline__ uint32_t mix_fast(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  return h;
}

__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h = mix_fast(h);
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t hash3(int ix, int iy, int iz, uint32_t seed) {
  return mix((uint32_t)ix * 0x9E3779B1u + (uint32_t)iy * 0x85EBCA77u +
             (uint32_t)iz * 0xC2B2AE3Du + seed);
}

__device__ __forceinline__ float hash_to_unit(uint32_t h) {
  return (float)(h >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float full_to_signed(uint32_t h) {
  return (float)(int32_t)h * 4.656612873077392578125e-10f;  // 2^-31
}

__device__ __forceinline__ float bits_to_signed(uint32_t h, int shift) {
  return (float)((h >> shift) & 1023u) * (1.0f / 512.0f) - 1.0f;
}

__device__ __forceinline__ float floor_split(float x, int& i) {
  float f = floorf(x);
  i = (int)f;
  return x - f;
}

__device__ __forceinline__ float cubic(float t) { return t * t * (3.0f - 2.0f * t); }

// corner hashes ordered c000, c100, c010, c110, c001, c101, c011, c111
__device__ __forceinline__ void corner_hashes(int ix, int iy, int iz, uint32_t seed,
                                              uint32_t h[8]) {
  uint32_t hx0 = (uint32_t)ix * 0x9E3779B1u;
  uint32_t hy0 = (uint32_t)iy * 0x85EBCA77u;
  uint32_t hz0 = (uint32_t)iz * 0xC2B2AE3Du + seed;
  uint32_t hx1 = hx0 + 0x9E3779B1u;
  uint32_t hy1 = hy0 + 0x85EBCA77u;
  uint32_t hz1 = hz0 + 0xC2B2AE3Du;
  h[0] = mix_fast(hx0 + hy0 + hz0);
  h[1] = mix_fast(hx1 + hy0 + hz0);
  h[2] = mix_fast(hx0 + hy1 + hz0);
  h[3] = mix_fast(hx1 + hy1 + hz0);
  h[4] = mix_fast(hx0 + hy0 + hz1);
  h[5] = mix_fast(hx1 + hy0 + hz1);
  h[6] = mix_fast(hx0 + hy1 + hz1);
  h[7] = mix_fast(hx1 + hy1 + hz1);
}

__device__ __forceinline__ float trilerp(const float c[8], float ux, float uy, float uz) {
  float x00 = c[0] + (c[1] - c[0]) * ux;
  float x10 = c[2] + (c[3] - c[2]) * ux;
  float x01 = c[4] + (c[5] - c[4]) * ux;
  float x11 = c[6] + (c[7] - c[6]) * ux;
  float y0 = x00 + (x10 - x00) * uy;
  float y1 = x01 + (x11 - x01) * uy;
  return y0 + (y1 - y0) * uz;
}

__device__ float value_noise3(float x, float y, float z, uint32_t seed) {
  int ix, iy, iz;
  float fx = floor_split(x, ix), fy = floor_split(y, iy), fz = floor_split(z, iz);
  uint32_t h[8];
  corner_hashes(ix, iy, iz, seed, h);
  float c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) c[k] = full_to_signed(h[k]);
  return trilerp(c, cubic(fx), cubic(fy), cubic(fz));
}

__device__ void value_noise3_vec3(float x, float y, float z, uint32_t seed,
                                  float& ox, float& oy, float& oz) {
  int ix, iy, iz;
  float fx = floor_split(x, ix), fy = floor_split(y, iy), fz = floor_split(z, iz);
  float ux = cubic(fx), uy = cubic(fy), uz = cubic(fz);
  uint32_t h[8];
  corner_hashes(ix, iy, iz, seed, h);
  float c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) c[k] = bits_to_signed(h[k], 0);
  ox = trilerp(c, ux, uy, uz);
#pragma unroll
  for (int k = 0; k < 8; ++k) c[k] = bits_to_signed(h[k], 10);
  oy = trilerp(c, ux, uy, uz);
#pragma unroll
  for (int k = 0; k < 8; ++k) c[k] = bits_to_signed(h[k], 20);
  oz = trilerp(c, ux, uy, uz);
}

__device__ __forceinline__ float lattice_sum(int jx, int jy, int jz, float gx, float gy,
                                             float gz, uint32_t seed) {
  uint32_t h[8];
  corner_hashes(jx, jy, jz, seed, h);
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float cx = gx - (float)(k & 1);
    float cy = gy - (float)((k >> 1) & 1);
    float cz = gz - (float)((k >> 2) & 1);
    float a = fmaxf(0.75f - cx * cx - cy * cy - cz * cz, 0.0f);
    float a2 = a * a;
    float g = bits_to_signed(h[k], 0) * cx + bits_to_signed(h[k], 10) * cy +
              bits_to_signed(h[k], 20) * cz;
    float c = a2 * a2 * g;
    total = (k == 0) ? c : total + c;
  }
  return total;
}

__device__ float simplex_smooth_noise3(float x, float y, float z, uint32_t seed) {
  const float r3 = (float)(2.0 / 3.0);
  float r = (x + y + z) * r3;
  int ix, iy, iz;
  float fx = floor_split(r - x, ix), fy = floor_split(r - y, iy), fz = floor_split(r - z, iz);
  float n = lattice_sum(ix, iy, iz, fx, fy, fz, seed);
  int bx = fx < 0.5f, by = fy < 0.5f, bz = fz < 0.5f;
  n = n + lattice_sum(ix - bx, iy - by, iz - bz, fx + (float)bx - 0.5f,
                      fy + (float)by - 0.5f, fz + (float)bz - 0.5f, seed + 1293373u);
  return n * 7.3f;
}

__device__ __forceinline__ float quintic(float t) {
  return t * t * t * (t * (t * 6.0f - 15.0f) + 10.0f);
}

__device__ __forceinline__ float grad_dot(uint32_t h, float x, float y, float z) {
  return bits_to_signed(h, 0) * x + bits_to_signed(h, 10) * y + bits_to_signed(h, 20) * z;
}

__device__ float perlin_noise3(float x, float y, float z, uint32_t seed) {
  int ix, iy, iz;
  float fx = floor_split(x, ix), fy = floor_split(y, iy), fz = floor_split(z, iz);
  uint32_t h[8];
  corner_hashes(ix, iy, iz, seed, h);
  float c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    c[k] = grad_dot(h[k], fx - (float)(k & 1), fy - (float)((k >> 1) & 1),
                    fz - (float)((k >> 2) & 1));
  return trilerp(c, quintic(fx), quintic(fy), quintic(fz)) * 1.15f;
}

// classic 3D simplex: 4 corners, ranked branch-free (ties broken x > y > z)
__device__ float simplex_noise3(float x, float y, float z, uint32_t seed) {
  const float F3 = (float)(1.0 / 3.0), G3 = (float)(1.0 / 6.0);
  const float s = (x + y + z) * F3;
  const int ix = (int)floorf(x + s), iy = (int)floorf(y + s), iz = (int)floorf(z + s);
  const float t = (float)(ix + iy + iz) * G3;
  const float x0 = x - ((float)ix - t), y0 = y - ((float)iy - t), z0 = z - ((float)iz - t);
  const int rx = (x0 < y0) + (x0 < z0), ry = (x0 >= y0) + (y0 < z0), rz = (x0 >= z0) + (y0 >= z0);
  const int i1 = rx == 0, j1 = ry == 0, k1 = rz == 0, i2 = rx <= 1, j2 = ry <= 1, k2 = rz <= 1;
  const float c[4][3] = {
      {x0, y0, z0},
      {x0 - (float)i1 + G3, y0 - (float)j1 + G3, z0 - (float)k1 + G3},
      {x0 - (float)i2 + (float)(2.0 * (1.0 / 6.0)), y0 - (float)j2 + (float)(2.0 * (1.0 / 6.0)),
       z0 - (float)k2 + (float)(2.0 * (1.0 / 6.0))},
      {x0 - 1.0f + (float)(3.0 * (1.0 / 6.0)), y0 - 1.0f + (float)(3.0 * (1.0 / 6.0)),
       z0 - 1.0f + (float)(3.0 * (1.0 / 6.0))}};
  const int d[4][3] = {{0, 0, 0}, {i1, j1, k1}, {i2, j2, k2}, {1, 1, 1}};
  float n = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float tt = fmaxf(0.6f - c[k][0] * c[k][0] - c[k][1] * c[k][1] - c[k][2] * c[k][2], 0.0f);
    tt = tt * tt;
    const uint32_t h = hash3(ix + d[k][0], iy + d[k][1], iz + d[k][2], seed);
    const float v = tt * tt * grad_dot(h, c[k][0], c[k][1], c[k][2]);
    n = k == 0 ? v : n + v;
  }
  return n * 32.0f;
}

// the jittered feature point of the cell whose hash3 is h, as an offset
__device__ __forceinline__ void feature_offset(uint32_t h, float jitter, float& ox, float& oy,
                                               float& oz) {
  ox = hash_to_unit(h) * jitter;
  oy = hash_to_unit(mix(h ^ 0xABCD1234u)) * jitter;
  oz = hash_to_unit(mix(h ^ 0x1B56C4E9u)) * jitter;
}

// Worley noise over the 3 x 3 x 3 cells: F1 (distance), F2 - F1
// (distance2) or the closest cell's hashed value (cell_value).  The
// coordinate multiplies of hash3 are hoisted (uint32 arithmetic is
// modular, so (ix + dx) * A = ix * A + dx * A bit for bit).
__device__ float cellular_noise3(float x, float y, float z, uint32_t seed, float jitter,
                                 int ret) {
  int ix, iy, iz;
  const float fx = floor_split(x, ix), fy = floor_split(y, iy), fz = floor_split(z, iz);
  const uint32_t hx = (uint32_t)ix * 0x9E3779B1u, hy = (uint32_t)iy * 0x85EBCA77u;
  const uint32_t hz = (uint32_t)iz * 0xC2B2AE3Du + seed;
  float f1 = 1e10f, f2 = 1e10f;
  uint32_t closest = 0u;
#pragma unroll
  for (int dz = -1; dz <= 1; ++dz) {
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const uint32_t h = mix(hx + (uint32_t)dx * 0x9E3779B1u + hy + (uint32_t)dy * 0x85EBCA77u +
                               hz + (uint32_t)dz * 0xC2B2AE3Du);
        float ox, oy, oz;
        feature_offset(h, jitter, ox, oy, oz);
        const float ddx = (float)dx + ox - fx, ddy = (float)dy + oy - fy, ddz = (float)dz + oz - fz;
        const float dd = ddx * ddx + ddy * ddy + ddz * ddz;
        const bool closer = dd < f1;
        f2 = closer ? f1 : fminf(f2, dd);
        closest = closer ? h : closest;
        f1 = closer ? dd : f1;
      }
    }
  }
  if (ret == 2) return hash_to_unit(closest) * 2.0f - 1.0f;
  if (ret == 1) return sqrtf(f2) - sqrtf(f1) - 1.0f;
  return sqrtf(f1) * 2.0f - 1.0f;
}

// 8-cell Worley F1: the 2 x 2 x 2 cells around the nearest lattice corner,
// the feature points of cellular_noise3
__device__ float cellular_noise3_fast(float x, float y, float z, uint32_t seed, float jitter) {
  int ix, iy, iz;
  const float fx = floor_split(x, ix), fy = floor_split(y, iy), fz = floor_split(z, iz);
  const int bx = (fx >= 0.5f) - 1, by = (fy >= 0.5f) - 1, bz = (fz >= 0.5f) - 1;
  const uint32_t hx0 = (uint32_t)(ix + bx) * 0x9E3779B1u, hy0 = (uint32_t)(iy + by) * 0x85EBCA77u;
  const uint32_t hz0 = (uint32_t)(iz + bz) * 0xC2B2AE3Du + seed;
  const float fbx = (float)bx - fx, fby = (float)by - fy, fbz = (float)bz - fz;
  float f1 = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k & 1, dy = (k >> 1) & 1, dz = (k >> 2) & 1;
    const uint32_t h = mix(hx0 + (dx ? 0x9E3779B1u : 0u) + hy0 + (dy ? 0x85EBCA77u : 0u) + hz0 +
                           (dz ? 0xC2B2AE3Du : 0u));
    float ox, oy, oz;
    feature_offset(h, jitter, ox, oy, oz);
    const float ddx = fbx + (float)dx + ox, ddy = fby + (float)dy + oy, ddz = fbz + (float)dz + oz;
    const float dd = ddx * ddx + ddy * ddy + ddz * ddz;
    f1 = k == 0 ? dd : fminf(f1, dd);
  }
  return sqrtf(f1) * 2.0f - 1.0f;
}

// The noise basis of a spec.
__device__ __forceinline__ float base_noise(const NoiseParams& s, float x, float y, float z,
                                            uint32_t seed) {
  switch (s.noise_type) {
    case 0: return value_noise3(x, y, z, seed);
    case 1: return simplex_smooth_noise3(x, y, z, seed);
    case 2: return perlin_noise3(x, y, z, seed);
    case 3: return simplex_noise3(x, y, z, seed);
    case 4: return cellular_noise3(x, y, z, seed, s.cellular_jitter, s.cellular_return);
    default: return cellular_noise3_fast(x, y, z, seed, s.cellular_jitter);
  }
}

// sample_noise3: domain warp -> fractal -> base, at field coordinates.
// weighted_strength scales each next octave's amplitude by a weight of this
// octave's value (JAX ops/noise.py:505-518: the amplitude is then a
// per-sample f32 chain, amp * weight * gain).  The struct holds the tables
// of the first MK_INLINE_OCTAVES octaves and warp octaves (octaves,
// warp_octaves); a spec with more reads the rest from its buffer (s.ext,
// MK_EXT_OCTAVE floats per octave: amp, warp_amp, warp_freq).  Only the
// EXT build reads the buffer: the other is the struct's loop alone, since
// any code for the buffer's octaves in the inlined march (a branch, a
// second loop or a call) slowed megakernel_gen's 1080p frames by 2-10 % on
// an H100 (compare_megakernel.py).
template <bool EXT>
__device__ float sample_noise3(const NoiseParams& s, float x, float y, float z) {
  if (s.warp_enabled) {
    for (int o = 0; o < (EXT ? s.warp_octaves + s.ext_warp_octaves : s.warp_octaves); ++o) {
      float f;
      if constexpr (EXT)
        f = o < MK_INLINE_OCTAVES ? s.warp_freq[o]
                                  : s.ext[MK_EXT_OCTAVE * (o - MK_INLINE_OCTAVES) + 2];
      else
        f = s.warp_freq[o];
      float sx, sy, sz;
      value_noise3_vec3(x * f, y * f, z * f, (uint32_t)(s.seed + 1000 + o), sx, sy, sz);
      float a;
      if constexpr (EXT)
        a = o < MK_INLINE_OCTAVES ? s.warp_amp[o]
                                  : s.ext[MK_EXT_OCTAVE * (o - MK_INLINE_OCTAVES) + 1];
      else
        a = s.warp_amp[o];
      x = x + sx * a;
      y = y + sy * a;
      z = z + sz * a;
    }
  }
  x = x * s.frequency;
  y = y * s.frequency;
  z = z * s.frequency;
  if (s.fractal_type == 0) return base_noise(s, x, y, z, (uint32_t)s.seed);
  float total = 0.0f;
  const bool weighted = s.weighted_strength != 0.0f;
  float amp = s.amp[0];
  for (int o = 0; o < (EXT ? s.octaves + s.ext_octaves : s.octaves); ++o) {
    float n = base_noise(s, x, y, z, (uint32_t)(s.seed + o));
    float a;
    if constexpr (EXT)
      a = weighted ? amp
          : o < MK_INLINE_OCTAVES ? s.amp[o]
                                  : s.ext[MK_EXT_OCTAVE * (o - MK_INLINE_OCTAVES)];
    else
      a = weighted ? amp : s.amp[o];
    float w;  // the weight's value term
    if (s.fractal_type == 1) {
      total = total + n * a;
      w = fminf(n + 1.0f, 2.0f) * 0.5f - 1.0f;
    } else if (s.fractal_type == 2) {
      n = fabsf(n);
      total = total + (n * -2.0f + 1.0f) * a;
      w = (1.0f - n) - 1.0f;
    } else {
      float t = (n + 1.0f) * s.ping_pong_strength;
      t = t - floorf(t * 0.5f) * 2.0f;
      t = t < 1.0f ? t : 2.0f - t;
      total = total + (t - 0.5f) * 2.0f * a;
      w = t - 1.0f;
    }
    if (weighted) amp = amp * (1.0f + w * s.weighted_strength) * s.gain;
    x = x * s.lacunarity;
    y = y * s.lacunarity;
    z = z * s.lacunarity;
  }
  return total;
}

// procedural field 0.5 + 0.5 * noise(p * scale); the launch struct is a
// __grid_constant__, so its noise specs are read in place.  Inlined at the
// march's per-step and per-sun-sample sites (march_field), called from the
// knots' sites (field).  EXT: the launch reads the scene's buffer
// (scene_buffer), so a spec may hold octaves there.
template <bool EXT>
__device__ __forceinline__ float march_field(const NoiseParams& s, V3 p) {
  return 0.5f + 0.5f * sample_noise3<EXT>(s, p.x * s.scale[0], p.y * s.scale[1], p.z * s.scale[2]);
}

template <bool EXT>
__device__ __noinline__ float field(const NoiseParams& s, V3 p) { return march_field<EXT>(s, p); }

// whether a launch reads the scene's buffer (spheres and boxes past the
// struct's, or a procedural field's octaves past its): it then takes each
// kernel's EXT instance, whose opaque pass and noise read the buffer; the
// other instances are the struct's code alone
__host__ __device__ inline bool scene_buffer(const MegakernelParams& p) {
  return (p.ext_spheres | p.ext_boxes | p.shape.ext_octaves | p.shape.ext_warp_octaves |
          p.coverage.ext_octaves | p.coverage.ext_warp_octaves) != 0;
}

// ---------------------------------------------------------------------------
// Opaque pass (render/opaque.py)

// world-space ray direction of pixel (x, y), uncontracted in the plain
// version's operation order: every caller gets the same bits for a pixel
// (the sky's tile choice recomputes the rays the opaque pass samples)
__device__ __forceinline__ V3 pixel_dir(const MegakernelParams& p, int x, int y) {
  const float ndc_x = 2.0f * ((float)x + 0.5f) / (float)p.width - 1.0f;
  const float ndc_y = 1.0f - 2.0f * ((float)y + 0.5f) / (float)p.height;
  const float vx = __fmul_rn(ndc_x, p.ray_sx), vy = __fmul_rn(ndc_y, p.ray_sy);
  const float inv = rsqrtf(__fadd_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)), 1.0f));
  const float dx = __fmul_rn(vx, inv), dy = __fmul_rn(vy, inv), dz = -inv;
  const float* m = p.cam_rot;
  return v3(__fadd_rn(__fadd_rn(__fmul_rn(m[0], dx), __fmul_rn(m[1], dy)), __fmul_rn(m[2], dz)),
            __fadd_rn(__fadd_rn(__fmul_rn(m[3], dx), __fmul_rn(m[4], dy)), __fmul_rn(m[5], dz)),
            __fadd_rn(__fadd_rn(__fmul_rn(m[6], dx), __fmul_rn(m[7], dy)), __fmul_rn(m[8], dz)));
}

// One sphere of the opaque pass from the scene's buffer: a closer hit
// takes the pixel's distance, normal, albedo and shading flag.  The
// struct's spheres and boxes keep their own loops in opaque_pass: through
// these helpers they changed megakernel_gen's SASS and cost its 1080p
// frames up to 2 % on an H100 (compare_megakernel.py).
__device__ __forceinline__ void opaque_sphere(V3 c, float radius2, const float* albedo,
                                              const float* unshaded_i, V3 ro, V3 rd,
                                              float& best_t, V3& n, V3& alb, float& unshaded) {
  float t0, t1;
  ray_sphere(c, radius2, ro, rd, t0, t1);
  bool hit = (t0 != t1) && (t1 > 0.0f);
  float t = t0 > 0.0f ? t0 : t1;
  if (hit && t < best_t) {
    best_t = t;
    n = normalize(sub(add(ro, mul(rd, t)), c));
    alb = load3(albedo);
    unshaded = *unshaded_i;
  }
}

// One box of the opaque pass from the scene's buffer (m: its row-major
// world_to_box, ro_b: the camera position in box space).
__device__ __forceinline__ void opaque_box(const float* m, V3 ro_b, V3 hs, const float* albedo,
                                           V3 rd, float& best_t, V3& n, V3& alb,
                                           float& unshaded) {
  V3 rd_b = xform_dir(m, 4, rd);
  // safe reciprocal: axis-aligned rays get a huge finite slope
  float d[3] = {rd_b.x, rd_b.y, rd_b.z};
  float inv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float dk = fabsf(d[k]) < 1e-12f ? (d[k] < 0.0f ? -1e-12f : 1e-12f) : d[k];
    inv[k] = 1.0f / dk;
  }
  V3 nn = v3(inv[0] * ro_b.x, inv[1] * ro_b.y, inv[2] * ro_b.z);
  V3 kk = v3(fabsf(inv[0]) * hs.x, fabsf(inv[1]) * hs.y, fabsf(inv[2]) * hs.z);
  V3 t1 = sub(v3(-nn.x, -nn.y, -nn.z), kk);
  V3 t2 = add(v3(-nn.x, -nn.y, -nn.z), kk);
  float t_near = fmaxf(fmaxf(t1.x, t1.y), t1.z);
  float t_far = fminf(fminf(t2.x, t2.y), t2.z);
  bool hit = (t_near <= t_far) && (t_far >= 0.0f);
  if (!hit) {
    t_near = -1.0f;
    t_far = -1.0f;
  }
  float t = t_near > 0.0f ? t_near : t_far;
  if (hit && t > 0.0f && t < best_t) {
    V3 pb = add(ro_b, mul(rd_b, t));
    float axx = fabsf(pb.x / hs.x), ayy = fabsf(pb.y / hs.y), azz = fabsf(pb.z / hs.z);
    V3 nl = v3((axx >= ayy && axx >= azz) ? fsign(pb.x) : 0.0f,
               (ayy > axx && ayy >= azz) ? fsign(pb.y) : 0.0f,
               (azz > axx && azz > ayy) ? fsign(pb.z) : 0.0f);
    best_t = t;
    n = v3(m[0] * nl.x + m[4] * nl.y + m[8] * nl.z,
           m[1] * nl.x + m[5] * nl.y + m[9] * nl.z,
           m[2] * nl.x + m[6] * nl.y + m[10] * nl.z);
    alb = load3(albedo);
    unshaded = 0.0f;
  }
}

// a point through a row-major 4x4 in the host's operation order, each
// product and sum rounded once (utils/camera.py::transform_point on f32
// tensors): the camera position in the box space of a box from the buffer
__device__ __forceinline__ V3 xform_point_rn(const float* m, V3 q) {
  return v3(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], q.x), __fmul_rn(m[1], q.y)),
                                __fmul_rn(m[2], q.z)), m[3]),
            __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[4], q.x), __fmul_rn(m[5], q.y)),
                                __fmul_rn(m[6], q.z)), m[7]),
            __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[8], q.x), __fmul_rn(m[9], q.y)),
                                __fmul_rn(m[10], q.z)), m[11]));
}

// The closest hit among the spheres and boxes past the launch struct's
// (ext_spheres, ext_boxes; MK_GEOM_SPHERE and MK_GEOM_BOX floats each in
// the scene's buffer geom), given the struct's closest: the same tests in
// the same order.  Called, not inlined, so the inlined opaque pass is the
// struct's geometry's alone; it takes values, not the launch struct, whose
// address some instances' parameters cannot give without a local copy.
struct OpaqueHit {
  float t;
  V3 n, alb;
  float unshaded;
};

__device__ __noinline__ OpaqueHit opaque_tail(const float* __restrict__ geom, int ext_spheres,
                                              int ext_boxes, V3 cam, V3 ro, V3 rd,
                                              OpaqueHit h) {
  for (int i = 0; i < ext_spheres; ++i) {
    const float* g = geom + MK_GEOM_SPHERE * i;
    opaque_sphere(load3(g), g[3], g + 4, g + 7, ro, rd, h.t, h.n, h.alb, h.unshaded);
  }
  const float* boxes = geom + MK_GEOM_SPHERE * ext_spheres;
  for (int i = 0; i < ext_boxes; ++i) {
    const float* g = boxes + MK_GEOM_BOX * i;
    opaque_box(g, xform_point_rn(g, cam), load3(g + 16), g + 19, rd, h.t, h.n, h.alb,
               h.unshaded);
  }
  return h;
}

// the closest hit's shaded color and distance; a miss gets linear depth 1e7
// and, without a sky, sky_color plus the starfield (with one, the caller
// samples it).  Returns whether the ray hit.  The launch struct holds the
// first MK_INLINE_SPHERES spheres and MK_INLINE_BOXES boxes (n_spheres,
// n_boxes); EXT: a scene with more continues in opaque_tail.
template <bool EXT>
__device__ bool opaque_pass(const MegakernelParams& p, V3 ro, V3 rd, V3& rgb,
                            float& linear_depth) {
  const float big = 3.0e38f;
  float best_t = big;
  V3 n = v3(0.0f, 0.0f, 0.0f), alb = v3(0.0f, 0.0f, 0.0f);
  float unshaded = 0.0f;
  for (int i = 0; i < p.n_spheres; ++i) {
    V3 c = load3(p.sphere_center + 3 * i);
    float t0, t1;
    ray_sphere(c, p.sphere_radius2[i], ro, rd, t0, t1);
    bool hit = (t0 != t1) && (t1 > 0.0f);
    float t = t0 > 0.0f ? t0 : t1;
    if (hit && t < best_t) {
      best_t = t;
      n = normalize(sub(add(ro, mul(rd, t)), c));
      alb = load3(p.sphere_albedo + 3 * i);
      unshaded = p.sphere_unshaded[i];
    }
  }
  for (int i = 0; i < p.n_boxes; ++i) {
    const float* m = p.box_w2b + 16 * i;
    V3 ro_b = load3(p.box_origin + 3 * i);
    V3 rd_b = xform_dir(m, 4, rd);
    V3 hs = load3(p.box_half + 3 * i);
    // safe reciprocal: axis-aligned rays get a huge finite slope
    float d[3] = {rd_b.x, rd_b.y, rd_b.z};
    float inv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float dk = fabsf(d[k]) < 1e-12f ? (d[k] < 0.0f ? -1e-12f : 1e-12f) : d[k];
      inv[k] = 1.0f / dk;
    }
    V3 nn = v3(inv[0] * ro_b.x, inv[1] * ro_b.y, inv[2] * ro_b.z);
    V3 kk = v3(fabsf(inv[0]) * hs.x, fabsf(inv[1]) * hs.y, fabsf(inv[2]) * hs.z);
    V3 t1 = sub(v3(-nn.x, -nn.y, -nn.z), kk);
    V3 t2 = add(v3(-nn.x, -nn.y, -nn.z), kk);
    float t_near = fmaxf(fmaxf(t1.x, t1.y), t1.z);
    float t_far = fminf(fminf(t2.x, t2.y), t2.z);
    bool hit = (t_near <= t_far) && (t_far >= 0.0f);
    if (!hit) {
      t_near = -1.0f;
      t_far = -1.0f;
    }
    float t = t_near > 0.0f ? t_near : t_far;
    if (hit && t > 0.0f && t < best_t) {
      V3 pb = add(ro_b, mul(rd_b, t));
      float axx = fabsf(pb.x / hs.x), ayy = fabsf(pb.y / hs.y), azz = fabsf(pb.z / hs.z);
      V3 nl = v3((axx >= ayy && axx >= azz) ? fsign(pb.x) : 0.0f,
                 (ayy > axx && ayy >= azz) ? fsign(pb.y) : 0.0f,
                 (azz > axx && azz > ayy) ? fsign(pb.z) : 0.0f);
      best_t = t;
      n = v3(m[0] * nl.x + m[4] * nl.y + m[8] * nl.z,
             m[1] * nl.x + m[5] * nl.y + m[9] * nl.z,
             m[2] * nl.x + m[6] * nl.y + m[10] * nl.z);
      alb = load3(p.box_albedo + 3 * i);
      unshaded = 0.0f;
    }
  }
  if constexpr (EXT) {
    if (p.ext_spheres | p.ext_boxes) {
      const OpaqueHit h = opaque_tail(p.geom, p.ext_spheres, p.ext_boxes, load3(p.cam_pos), ro,
                                      rd, OpaqueHit{best_t, n, alb, unshaded});
      best_t = h.t;
      n = h.n;
      alb = h.alb;
      unshaded = h.unshaded;
    }
  }
  bool hit_any = best_t < big;
  if (hit_any) {
    float ndotl = fmaxf(-(n.x * p.light_dir[0] + n.y * p.light_dir[1] + n.z * p.light_dir[2]),
                        0.0f);
    float shade = p.ambient + (1.0f - p.ambient) * ndotl;
    if (unshaded > 0.5f) shade = 1.0f;
    rgb = mul(alb, shade);
    linear_depth = best_t;
  } else {
    if (!p.with_sky) {
      // hashed starfield from the quantized ray direction
      uint32_t h = hash3((int)floorf(rd.x * 220.0f), (int)floorf(rd.y * 220.0f),
                         (int)floorf(rd.z * 220.0f), 77u);
      float b = hash_to_unit(h);
      float b2 = b * b, b4 = b2 * b2, b16 = b4 * b4;
      b16 = b16 * b16;
      float star = fmaxf(b16 - 0.7f, 0.0f) * (float)(1.0 / 0.3) * p.star_intensity;
      rgb = v3(p.sky_color[0] + star, p.sky_color[1] + star, p.sky_color[2] + star);
    }
    linear_depth = 1.0e7f;
  }
  return hit_any;
}

// ---------------------------------------------------------------------------
// v2 atmosphere (ops/atmosphere_v2.py, ops/optical_depth.py)

__device__ __forceinline__ float atmo_density(const MegakernelParams& p, float dist) {
  float h = saturate((dist - p.planet_radius) / p.atmosphere_height);
  float y = 1.0f - h;
  return y * y * y * p.density;
}

__device__ float od_segment(const MegakernelParams& p, float a0, float a1, float b, float q2) {
  float seg = a1 - a0;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < MK_QUAD_POINTS; ++k) {
    float t = a0 + seg * p.quad_x[k];
    float x = t + b;
    float r = sqrtf(x * x + q2);
    float y = 1.0f - fminf(fmaxf((r - p.planet_radius) * p.inv_height, 0.0f), 1.0f);
    acc = acc + p.quad_w[k] * (y * y * y);
  }
  return acc * seg * p.density2;
}

// The sun's optical depth from pos along dir; segs counts the quadrature
// segments evaluated.  The chord [s, e] through the shell splits at the
// ground crossings [g0, g1] into two smooth segments, [s, g0] and [g1, e],
// and the span below the ground.  Unless the sun ray crosses the ground
// ahead of the sample, g0 = g1 and one smooth segment is empty (g0 = g1 = e
// where the line misses the ground, = s where the ground lies behind the
// sample): the plain version integrates it to an exact +0 (seg = 0), and
// adds it and the span below, an exact +0 too.  Here such a chord evaluates
// only its non-empty segment, whose value is the plain sum's bit for bit:
// every rounding of a sum with two exact zero terms, fused or not, is the
// rounding of the third.  A chord through the ground keeps the plain
// expression whole.
__device__ float optical_depth_analytic(const MegakernelParams& p, V3 pos, V3 dir,
                                        unsigned& segs) {
  V3 rel = sub(pos, load3(p.planet_center));
  float r = sqrtf(rel.x * rel.x + rel.y * rel.y + rel.z * rel.z);
  float r_cl = fminf(fmaxf(r, p.planet_radius), p.atmosphere_radius);
  rel = mul(rel, r_cl / fmaxf(r, 1e-20f));
  float b = rel.x * dir.x + rel.y * dir.y + rel.z * dir.z;
  float c0 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z;
  float q2 = fmaxf(c0 - b * b, 0.0f);
  float ha = p.atmosphere_radius2 - q2;
  bool shell_hit = ha > 0.0f;
  float sq_a = shell_hit ? sqrtf(fmaxf(ha, 1e-12f)) : 0.0f;
  float s = fmaxf(-b - sq_a, 0.0f);
  float e = fmaxf(-b + sq_a, 0.0f);
  if (!shell_hit) e = s;
  float hg = p.planet_radius2 - q2;
  bool ground_hit = hg > 0.0f;
  float sq_g = ground_hit ? sqrtf(fmaxf(hg, 1e-12f)) : 0.0f;
  float g0 = ground_hit ? -b - sq_g : e;
  float g1 = ground_hit ? -b + sq_g : e;
  g0 = fminf(fmaxf(g0, s), e);
  g1 = fminf(fmaxf(g1, s), e);
  const bool near = s < g0, far = g1 < e;
  if (g0 == g1 && !(near && far)) {
    segs += (unsigned)near + (unsigned)far;
    return near || far ? od_segment(p, near ? s : g1, near ? g0 : e, b, q2) : 0.0f;
  }
  segs += 2;
  float below = (g1 - g0) * p.density2;
  return od_segment(p, s, g0, b, q2) + od_segment(p, g1, e, b, q2) + below;
}

// segs: the sun depth's quadrature segments evaluated, added to
__device__ void atmosphere_v2(const MegakernelParams& p, V3 ro, V3 rd, float t_begin,
                              float t_end, float jitter, float out[4], unsigned& segs) {
  V3 pc = load3(p.planet_center);
  V3 sun = load3(p.sun_dir);
  float step_len = (t_end - t_begin) / (float)p.atmosphere_steps;
  V3 pos = add(ro, mul(rd, t_begin));
  float tr = 0.0f, tg = 0.0f, tb = 0.0f, view_od = 0.0f, alpha = 0.0f;
  for (int i = 0; i < p.atmosphere_steps; ++i) {
    float sun_od = optical_depth_analytic(p, pos, sun, segs);
    V3 rel = sub(pos, pc);
    float height = sqrtf(rel.x * rel.x + rel.y * rel.y + rel.z * rel.z);
    float local_density = atmo_density(p, height) * p.density;
    view_od = view_od + local_density * step_len;
    float od = sun_od + view_od;
    tr = tr + local_density * step_len * expf(-od * p.scatter[0]) * p.scatter[0];
    tg = tg + local_density * step_len * expf(-od * p.scatter[1]) * p.scatter[1];
    tb = tb + local_density * step_len * expf(-od * p.scatter[2]) * p.scatter[2];
    float vt = expf(-local_density * step_len);
    alpha = alpha + (1.0f - vt) * (1.0f - alpha);
    pos = add(pos, mul(rd, step_len));
  }
  out[0] = saturate(tr + p.ambient_color[0]) * p.modulate[0];
  out[1] = saturate(tg + p.ambient_color[1]) * p.modulate[1];
  out[2] = saturate(tb + p.ambient_color[2]) * p.modulate[2];
  out[3] = fminf(fmaxf(alpha + jitter * 0.02f, 0.0f), 0.99f);
}

// ---------------------------------------------------------------------------
// v1 atmosphere (ops/atmosphere_v1.py): a fixed-step march of the extinction
// factor and a squared sun-facing term, then the four-color mix

__device__ void atmosphere_v1(const MegakernelParams& p, V3 ro, V3 rd, float t_begin,
                              float t_end, float out[4]) {
  const V3 pc = load3(p.planet_center);
  const V3 sun = load3(p.sun_dir);
  const float inv_steps = (float)(1.0 / (double)p.atmosphere_steps);
  const float step_len = (t_end - t_begin) * inv_steps;
  V3 pos = add(ro, mul(rd, t_begin));
  float factor = 1.0f, light_sum = 0.0f;
  for (int i = 0; i < p.atmosphere_steps; ++i) {
    const V3 rel = sub(pos, pc);
    const float d = sqrtf(rel.x * rel.x + rel.y * rel.y + rel.z * rel.z);
    const V3 up = mul(rel, 1.0f / d);
    const float dens = atmo_density(p, d);
    float light = saturate(1.2f * (sun.x * up.x + sun.y * up.y + sun.z * up.z) + 0.5f);
    light = light * light;
    light_sum = light_sum + light * inv_steps;
    factor = factor * (1.0f - dens * step_len);
    pos = add(pos, mul(rd, step_len));
  }
  const float af = 1.0f - factor;
  const float day_factor = saturate(light_sum * p.day_night_transition_scale);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float night = p.night_color0[c] + (p.night_color1[c] - p.night_color0[c]) * af;
    const float day = p.day_color0[c] + (p.day_color1[c] - p.day_color0[c]) * af;
    out[c] = night + (day - night) * day_factor;
  }
  out[3] = saturate(af);
}

// ---------------------------------------------------------------------------
// Clouds (ops/clouds.py)

__device__ __forceinline__ V3 coverage_point(const MegakernelParams& p, V3 pos) {
  return normalize(v3(p.coverage_rot[0] * pos.x + p.coverage_rot[1] * pos.z, pos.y,
                      p.coverage_rot[2] * pos.x + p.coverage_rot[3] * pos.z));
}

// where the detail field samples the shape field: pos * 15 + time * 0.01
__device__ __forceinline__ V3 detail_point(const MegakernelParams& p, V3 pos) {
  const float t = p.time * 0.01f;
  return v3(pos.x * 15.0f + t, pos.y * 15.0f + t, pos.z * 15.0f + t);
}

// Cloud density at height ratio hr, saturated, before the density scale
// (clouds.py::get_density_full); detail is 0.5 at low quality.
__device__ __forceinline__ float cloud_density(const MegakernelParams& p, float hr, float cov,
                                               float shape_raw, float detail) {
  float hc = 2.0f * hr - 1.0f;
  hc = fmaxf(1.0f - hc * hc, 0.0f);
  float coverage = cov - 0.25f * hr + p.cloud_coverage_bias;
  float shape = 0.5f + (shape_raw - 0.5f) * p.cloud_shape_factor;
  if (p.cloud_shape_invert == 1.0f) shape = 1.0f - shape;
  float density = (shape - 0.2f * detail + (-1.2f + (float)(1.5 - -1.2) * coverage)) * hc;
  return saturate(density * 50.0f - 20.0f);
}

// Knots of a field, read in the march from shared memory, stored
// knot-major with a stride of one block (bank-conflict free): the texture
// instance's for a fixed K, the procedural instance's for the launch's.
// Hat-sum knots (knot_dynamic = False) read the same two live knots: the
// hat sum's other terms are exact zeros.
template <int K>
struct SmemKnots {
  const float* k;  // knot j at k[j * stride]
  int stride;
  // the plain version's two-live-knot sum, uncontracted
  __device__ __forceinline__ float interp(float u01) const {
    float us = u01 * (float)K;
    float i0 = fminf(fmaxf(floorf(us), 0.0f), (float)(K - 1));
    const int seg = (int)i0;
    const float f = us - i0;
    return __fadd_rn(__fmul_rn(k[seg * stride], 1.0f - f), __fmul_rn(k[(seg + 1) * stride], f));
  }
};

struct GenKnots {
  const float* k;  // knot j at k[j * MK_TILE_COLS]; nullptr: the field per step
  int K;
  __device__ __forceinline__ float interp(float u01) const {
    const float us = u01 * (float)K;
    const float i0 = fminf(fmaxf(floorf(us), 0.0f), (float)(K - 1));
    const int seg = (int)i0;
    const float f = us - i0;
    return k[seg * MK_TILE_COLS] * (1.0f - f) + k[(seg + 1) * MK_TILE_COLS] * f;
  }
};

// Where a march step and its sun samples take their field values (raw
// coverage, raw shape, detail); sun_* get the step's value and the sample's
// position.
// The texture instance: coverage and shape from shared-memory knots, both
// reused by the sun samples; always-low density.
template <int K, int KS>
struct TexFields {
  SmemKnots<K> cov_knots;
  SmemKnots<KS> shape_knots;
  __device__ __forceinline__ float cov(const MegakernelParams&, float u01, V3) const {
    return cov_knots.interp(u01);
  }
  __device__ __forceinline__ float shape(const MegakernelParams&, float u01, V3) const {
    return shape_knots.interp(u01);
  }
  __device__ __forceinline__ float detail(const MegakernelParams&, float, V3) const { return 0.5f; }
  __device__ __forceinline__ float sun_cov(const MegakernelParams&, float c, V3) const { return c; }
  __device__ __forceinline__ float sun_shape(const MegakernelParams&, float s, V3) const {
    return s;
  }
  __device__ __forceinline__ float sun_detail(const MegakernelParams&, float, V3, float) const {
    return 0.5f;
  }
};

// the procedural instance's field evaluations (work counters)
struct FieldWork {
  unsigned cov, shape, detail;
};

// The procedural instance: each field from its knots, or evaluated per step
// and per sun sample (every basis); at full quality the detail field,
// whose sun samples take it only where the march's alpha is below 0.3
// (clouds.py:165-175: d_full or d_low).
template <bool EXT>
struct GenFields {
  GenKnots cov_knots, shape_knots, detail_knots;
  bool full;
  FieldWork* work;
  __device__ __forceinline__ float cov_at(const MegakernelParams& p, V3 pos) const {
    ++work->cov;
    return march_field<EXT>(p.coverage, coverage_point(p, pos));
  }
  __device__ __forceinline__ float shape_at(const MegakernelParams& p, V3 pos) const {
    ++work->shape;
    return march_field<EXT>(p.shape, mul(pos, p.cloud_shape_scale));
  }
  __device__ __forceinline__ float detail_at(const MegakernelParams& p, V3 pos) const {
    ++work->detail;
    return march_field<EXT>(p.shape, detail_point(p, pos));
  }
  __device__ __forceinline__ float cov(const MegakernelParams& p, float u01, V3 pos) const {
    return cov_knots.k ? cov_knots.interp(u01) : cov_at(p, pos);
  }
  __device__ __forceinline__ float shape(const MegakernelParams& p, float u01, V3 pos) const {
    return shape_knots.k ? shape_knots.interp(u01) : shape_at(p, pos);
  }
  __device__ __forceinline__ float detail(const MegakernelParams& p, float u01, V3 pos) const {
    if (!full) return 0.5f;
    return detail_knots.k ? detail_knots.interp(u01) : detail_at(p, pos);
  }
  __device__ __forceinline__ float sun_cov(const MegakernelParams& p, float c, V3 pos) const {
    return cov_knots.k ? c : cov_at(p, pos);
  }
  __device__ __forceinline__ float sun_shape(const MegakernelParams& p, float s, V3 pos) const {
    return shape_knots.k ? s : shape_at(p, pos);
  }
  __device__ __forceinline__ float sun_detail(const MegakernelParams& p, float d, V3 pos,
                                              float alpha0) const {
    if (!full || !(alpha0 < 0.3f)) return 0.5f;
    return detail_knots.k ? d : detail_at(p, pos);
  }
};

// Raymarched lighting (clouds.py::get_light_raymarched): MK_SUN_STEPS sun
// samples, sample i at pos0 + sd * (i * len_i) with len_i = sun_step0 *
// 1.2^i (the sample's own length, not a cumulative sum), each field's
// value from F (the step's, or evaluated at the sample).  Kept rolled.
template <class F>
__device__ float sun_march(const MegakernelParams& p, const F& f, V3 pos0, float hr0, float cov,
                           float shape_raw, float detail, float alpha0) {
  const V3 sd = load3(p.sd_model);
  float len = p.sun_step0, alpha = 0.0f;
#pragma unroll 1
  for (int i = 0; i < MK_SUN_STEPS; ++i) {
    const V3 pos = add(pos0, mul(sd, (float)i * len));
    const float hr = (sqrtf(dot(pos, pos)) - p.cloud_bottom_radius) / p.cloud_layer;
    const float d = cloud_density(p, hr, f.sun_cov(p, cov, pos), f.sun_shape(p, shape_raw, pos),
                                  f.sun_detail(p, detail, pos, alpha0));
    const float tr = expf(-(d * (len * p.cloud_density_scale)));
    alpha = alpha + (1.0f - tr) * (1.0f - alpha);
    len = len * 1.2f;
  }
  return 1.0f + (hr0 * 0.2f - 1.0f) * alpha;
}

// One cloud march step: returns the scaled density, updates light.
template <class F>
__device__ float cloud_step(const MegakernelParams& p, const F& f, V3 pos, V3 rd, float alpha,
                            float cov, float shape_raw, float detail, float& light) {
  V3 sd = load3(p.sd_model);
  float pos_len = sqrtf(dot(pos, pos));
  float hr = (pos_len - p.cloud_bottom_radius) / p.cloud_layer;
  float l;
  if (p.raymarched_lighting) {
    l = sun_march(p, f, pos, hr, cov, shape_raw, detail, alpha);
  } else {
    // cheap lighting: height ratio plus a pow16 sun glow through thin cloud
    float dp = rd.x * sd.x + rd.y * sd.y + rd.z * sd.z;
    float dp2 = dp * dp, dp4 = dp2 * dp2, dp8 = dp4 * dp4;
    float glow = dp > 0.0f ? dp8 * dp8 : 0.0f;
    l = hr + glow * (1.0f - alpha);
  }
  // planet shadow
  float d = -(pos.x * sd.x + pos.y * sd.y + pos.z * sd.z) * (1.0f / pos_len);
  float st = saturate((d - (-0.3f)) / 0.6f);
  float shadow = st * st * (3.0f - 2.0f * st);
  light = l * (1.0f + (float)(0.002 - 1.0) * shadow);
  return cloud_density(p, hr, cov, shape_raw, detail) * p.cloud_density_scale;
}

// The march over [t_begin, t_end] (model space), its fields from F.
template <class F>
__device__ __forceinline__ void cloud_march(const MegakernelParams& p, const F& f, V3 rd,
                                            float t_begin, float t_end, float jitter,
                                            float& light_out, float& alpha_out) {
  V3 ro = load3(p.ro_model);
  t_end = t_begin + fminf(t_end - t_begin, p.march_max_distance);
  const int steps = p.cloud_steps;
  const float inv_steps = (float)(1.0 / (double)steps);
  float step_len = (t_end - t_begin) * inv_steps;
  V3 start = add(add(ro, mul(rd, jitter * step_len)), mul(rd, t_begin));
  float prod = 1.0f, total_t = 1.0f, total_light = 0.0f;
  for (int i = 0; i < steps; ++i) {
    float u01 = ((float)i + 0.5f) * inv_steps;
    V3 pos = add(start, mul(rd, (float)i * step_len));
    const float cov = f.cov(p, u01, pos);
    const float shape_raw = f.shape(p, u01, pos);
    const float detail = f.detail(p, u01, pos);
    float light;
    float density = cloud_step(p, f, pos, rd, 1.0f - prod, cov, shape_raw, detail, light);
    float tr = expf(-density * step_len);
    total_t = fmaxf(total_t * tr, 0.005f);
    total_light = total_light + light * density * step_len * total_t;
    prod = prod * tr;
  }
  light_out = total_light;
  alpha_out = 1.0f - prod;
}

// conservative density bound of a coverage group from its knots' maximum:
// a pixel at or below zero marches to exact zeros, so it is skipped (the
// detail term is 0.2 * 0.5 at low quality, 0 at full)
__device__ __forceinline__ bool cloud_may_form(const MegakernelParams& p, float cov_max) {
  cov_max = cov_max + p.cloud_coverage_bias;
  const float bound = (p.cloud_shape_bound - p.cloud_detail_term +
                       (-1.2f + (float)(1.5 - -1.2) * cov_max)) * 50.0f - 20.0f;
  return bound > 0.0f;
}

// ---------------------------------------------------------------------------
// K2: the texture samplers (ops/pallas/texsample.py::sample_tex3d,
// sample_latlong).  A batch is one thread block's positions at one knot
// group; its level and mode come from the min and max of the wrapped
// coordinates over the whole batch, with exactly the float comparisons of
// the TPU kernel, and every lookup is a direct __ldg gather from the flat
// pyramid (the TPU's windowed lane-gather scan equals it, given the fit
// checks).  Sums keep the TPU's order, uncontracted.

// Block-wide min and max of N values per thread; every thread receives the
// result.  red: 2 * N floats per warp of shared scratch.
template <int N>
__device__ __forceinline__ void block_minmax(float (&mn)[N], float (&mx)[N], float* red) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nwarps = (blockDim.x * blockDim.y + 31) >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    for (int off = 16; off > 0; off >>= 1) {
      mn[k] = fminf(mn[k], __shfl_xor_sync(0xffffffffu, mn[k], off));
      mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], off));
    }
  }
  __syncthreads();  // the previous batch's readers are done with red
  if ((tid & 31) == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      red[(tid >> 5) * 2 * N + k] = mn[k];
      red[(tid >> 5) * 2 * N + N + k] = mx[k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    mn[k] = red[k];
    mx[k] = red[N + k];
  }
  for (int w = 1; w < nwarps; ++w) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      mn[k] = fminf(mn[k], red[w * 2 * N + k]);
      mx[k] = fmaxf(mx[k], red[w * 2 * N + N + k]);
    }
  }
}

struct TexChoice {
  int mode;  // MK_WINDOWED, MK_BANDED or MK_FLOOR
  int level;
};

__device__ __forceinline__ TexChoice tex3d_choose(const TexParams& t, const float mn[3],
                                                  const float mx[3]) {
  int sel = t.shape_floor, sel_b = t.shape_floor;
  bool windowed = false, banded = false;
  for (int i = t.shape_levels - 1; i >= 0; --i) {  // coarse to fine: finest wins
    const float S = (float)t.shape_size[i];
    bool ok = true;
    float span = 0.0f, pitch = 1.0f, sp[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float i_lo = floorf(mn[ax] * S - 0.5f);  // S is a power of two: exact product
      const float i_hi = floorf(mx[ax] * S - 0.5f) + 1.0f;
      ok = ok && i_lo >= 0.0f && i_hi <= S - 1.0f;
      span = span + (i_hi - i_lo) * pitch;  // integers: exact
      sp[ax] = i_hi - i_lo;
      pitch = pitch * S;
    }
    if (ok && span + 127.0f <= (float)(t.window_rows * 128 - 1)) {
      sel = i;
      windowed = true;
    }
    if (t.band_rows && ok && sp[1] * S + sp[0] + 127.0f <= (float)(t.band_rows * 128 - 1) &&
        sp[2] + 1.0f <= (float)t.band_max_slices) {
      sel_b = i;
      banded = true;
    }
  }
  if (banded && (!windowed || sel_b < sel)) return TexChoice{MK_BANDED, sel_b};
  if (windowed) return TexChoice{MK_WINDOWED, sel};
  return TexChoice{MK_FLOOR, t.shape_floor};
}

__device__ __forceinline__ TexChoice latlong_choose(const TexParams& t, float umin, float umax,
                                                    float vmin, float vmax) {
  int sel = t.cov_floor;
  bool windowed = false;
  for (int i = t.cov_levels - 1; i >= 0; --i) {
    const float Hl = (float)t.cov_height[i], Wl = (float)t.cov_width[i];
    const float iu_lo = floorf(umin * Wl - 0.5f);
    const float iu_hi = floorf(umax * Wl - 0.5f) + 1.0f;
    const float iv_lo = fmaxf(floorf(vmin * Hl - 0.5f), 0.0f);
    const float iv_hi = fminf(floorf(vmax * Hl - 0.5f) + 1.0f, Hl - 1.0f);
    const bool ok = iu_lo >= 0.0f && iu_hi <= Wl - 1.0f;
    const float span = (iv_hi - iv_lo) * Wl + (iu_hi - iu_lo);
    if (ok && span + 127.0f <= (float)(t.window_rows * 128 - 1)) {
      sel = i;
      windowed = true;
    }
  }
  return windowed ? TexChoice{MK_WINDOWED, sel} : TexChoice{MK_FLOOR, t.cov_floor};
}

__device__ __forceinline__ float wrap01(float c) { return c - floorf(c); }

// one 3D sample at wrapped coordinates f (x, y, z) with the batch's choice
__device__ __forceinline__ float tex3d_sample(const TexParams& t, const float* __restrict__ tab,
                                              TexChoice ch, float fx, float fy, float fz) {
  if (ch.mode == MK_FLOOR) {
    const int S = t.shape_size[ch.level];
    const int m = S - 1;
    const int nx = (int)floorf(fx * (float)S) & m;
    const int ny = (int)floorf(fy * (float)S) & m;
    const int nz = (int)floorf(fz * (float)S) & m;
    return __ldg(tab + t.shape_base[ch.level] * 128 + (nz * S + ny) * S + nx);
  }
  const int S = t.shape_size[ch.level];
  const float Sf = (float)S;
  const float tx = fx * Sf - 0.5f, ty = fy * Sf - 0.5f, tz = fz * Sf - 0.5f;
  const float ix = floorf(tx), iy = floorf(ty), iz = floorf(tz);
  const float wx = tx - ix, wy = ty - iy, wz = tz - iz;
  const int x0 = (int)ix, y0 = (int)iy, z0 = (int)iz;  // no wrap by construction
  const float* b = tab + t.shape_base[ch.level] * 128;
  const int l00 = (z0 * S + y0) * S + x0, l01 = (z0 * S + y0 + 1) * S + x0;
  const int l10 = ((z0 + 1) * S + y0) * S + x0, l11 = ((z0 + 1) * S + y0 + 1) * S + x0;
  const float ax = 1.0f - wx, ay = 1.0f - wy, az = 1.0f - wz;
  const float c[8] = {__ldg(b + l00), __ldg(b + l00 + 1), __ldg(b + l01), __ldg(b + l01 + 1),
                      __ldg(b + l10), __ldg(b + l10 + 1), __ldg(b + l11), __ldg(b + l11 + 1)};
  const float w[8] = {__fmul_rn(__fmul_rn(az, ay), ax), __fmul_rn(__fmul_rn(az, ay), wx),
                      __fmul_rn(__fmul_rn(az, wy), ax), __fmul_rn(__fmul_rn(az, wy), wx),
                      __fmul_rn(__fmul_rn(wz, ay), ax), __fmul_rn(__fmul_rn(wz, ay), wx),
                      __fmul_rn(__fmul_rn(wz, wy), ax), __fmul_rn(__fmul_rn(wz, wy), wx)};
  float lo = __fmul_rn(c[0], w[0]);
#pragma unroll
  for (int k = 1; k < 4; ++k) lo = __fadd_rn(lo, __fmul_rn(c[k], w[k]));
  if (ch.mode == MK_BANDED) {  // the two z-slices' partial sums
    float hi = __fmul_rn(c[4], w[4]);
#pragma unroll
    for (int k = 5; k < 8; ++k) hi = __fadd_rn(hi, __fmul_rn(c[k], w[k]));
    return __fadd_rn(lo, hi);
  }
#pragma unroll
  for (int k = 4; k < 8; ++k) lo = __fadd_rn(lo, __fmul_rn(c[k], w[k]));
  return lo;
}

// the TPU kernel's polynomial atan2 and asin (texsample.py:243-269), with
// each multiply-add fused as the compiled JAX samplers evaluate it (the
// plain version rounds them once the same way)
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float t = fminf(ax, ay) / fmaxf(fmaxf(ax, ay), 1e-30f);
  const float t2 = __fmul_rn(t, t);
  float q = __fmaf_rn(t2, 0.0208351f, -0.0851330f);
  q = __fmaf_rn(t2, q, 0.1801410f);
  q = __fmaf_rn(t2, q, -0.3302995f);
  q = __fmaf_rn(t2, q, 0.9998660f);
  float a = __fmul_rn(t, q);
  if (ay > ax) a = (float)(3.14159265358979323846 / 2.0) - a;
  if (x < 0.0f) a = (float)3.14159265358979323846 - a;
  return y < 0.0f ? -a : a;
}

__device__ __forceinline__ float asin_poly(float y) {
  y = fminf(fmaxf(y, -1.0f), 1.0f);
  return atan2_poly(y, __fsqrt_rn(fmaxf(__fmaf_rn(-y, y, 1.0f), 0.0f)));
}

// unit direction -> lat-long (wrapped u, v)
__device__ __forceinline__ void latlong_uv(float dx, float dy, float dz, float& fu, float& v) {
  const float u = __fmaf_rn(atan2_poly(dz, dx), (float)(1.0 / (2.0 * 3.14159265358979323846)), 0.5f);
  v = __fmaf_rn(-asin_poly(dy), (float)(1.0 / 3.14159265358979323846), 0.5f);
  fu = u - floorf(u);
}

__device__ __forceinline__ float latlong_sample(const TexParams& t, const float* __restrict__ tab,
                                                TexChoice ch, float fu, float v) {
  const int Hi = t.cov_height[ch.level], Wi = t.cov_width[ch.level];
  const float Hs = (float)Hi, Ws = (float)Wi;
  const float* b = tab + t.cov_base[ch.level] * 128;
  if (ch.mode == MK_FLOOR) {
    const int un = (int)floorf(fu * Ws) & (Wi - 1);
    const int vn = min(max((int)floorf(v * Hs), 0), Hi - 1);
    return __ldg(b + vn * Wi + un);
  }
  const float tu = fu * Ws - 0.5f;
  const float u0f = floorf(tu);
  const float wu = tu - u0f;
  const int u0 = (int)u0f;
  const float tv = v * Hs - 0.5f;
  const float v0f = fminf(fmaxf(floorf(tv), 0.0f), Hs - 1.0f);
  const float wv = fminf(fmaxf(tv - v0f, 0.0f), 1.0f);
  const int v0 = (int)v0f;
  const int v1 = min(v0 + 1, Hi - 1);
  const float au = 1.0f - wu, av = 1.0f - wv;
  float s = __fmul_rn(__ldg(b + v0 * Wi + u0), __fmul_rn(av, au));
  s = __fadd_rn(s, __fmul_rn(__ldg(b + v0 * Wi + u0 + 1), __fmul_rn(av, wu)));
  s = __fadd_rn(s, __fmul_rn(__ldg(b + v1 * Wi + u0), __fmul_rn(wv, au)));
  return __fadd_rn(s, __fmul_rn(__ldg(b + v1 * Wi + u0 + 1), __fmul_rn(wv, wu)));
}

// ---------------------------------------------------------------------------
// The panorama sky: three channel pyramids sharing one meta (the sky's
// TexParams) and one choice per 32 x 128 tile of rays.

struct Sky {
  const TexParams& t;
  const float* r;
  const float* g;
  const float* b;
  TexChoice ch;
};

// The tile's level and mode: the min and max of (fu, v) over the rays of
// N rows from y0 in column x of every thread of the block (the block's
// rays are the tile's), with the lat-long sampler's window test.
template <int N>
__device__ __forceinline__ TexChoice sky_choice(const MegakernelParams& p, const TexParams& t,
                                                int x, int y0, float* red) {
  float mn[2] = {3.0e38f, 3.0e38f}, mx[2] = {-3.0e38f, -3.0e38f};
  for (int r = 0; r < N; ++r) {
    const V3 rd = pixel_dir(p, x, y0 + r);
    float fu, v;
    latlong_uv(rd.x, rd.y, rd.z, fu, v);
    mn[0] = fminf(mn[0], fu);
    mx[0] = fmaxf(mx[0], fu);
    mn[1] = fminf(mn[1], v);
    mx[1] = fmaxf(mx[1], v);
  }
  block_minmax<2>(mn, mx, red);
  return latlong_choose(t, mn[0], mx[0], mn[1], mx[1]);
}

__device__ __forceinline__ V3 sky_rgb(const Sky& sky, V3 rd) {
  float fu, v;
  latlong_uv(rd.x, rd.y, rd.z, fu, v);
  return v3(latlong_sample(sky.t, sky.r, sky.ch, fu, v), latlong_sample(sky.t, sky.g, sky.ch, fu, v),
            latlong_sample(sky.t, sky.b, sky.ch, fu, v));
}

// ---------------------------------------------------------------------------
// Per-thread frame state: one column and one group of G = cloud_lod *
// coverage_lod rows (one coverage group of cloud_lod-row coarse pixels).

// per-row shading of up to N rows
template <int N>
struct RowPix {
  V3 bg[N];
  float atm[N][4];
  bool hit[N];
};

// coarse (cloud_lod) row inputs of up to N coarse rows
template <int N>
struct CoarseIn {
  V3 rd_sum[N];
  float depth_min[N];
  float jit_first[N];
};

template <int N>
struct Coarse {
  V3 rd_model[N];
  float tb[N], tem[N];
  bool vis[N];
  bool any_vis;
  // coverage-group knot inputs: mean model-space ray (not renormalized)
  // and mean span
  V3 rk;
  float t0k, t1k;
};

// One pixel (x, y) of a layer: its ray, the opaque pass (whose misses
// sample the sky with its tile's choice when with_sky) or, for a chained
// layer, the color and linear depth of the layers below (read from color
// and depth), and the atmosphere.  A pixel past the launch's rows or the
// frame edge is computed too (it belongs to its tile; chained, it sees no
// geometry) but counts no work and writes nothing.  SHADE = false computes
// the coarse inputs alone (ray, linear depth, jitter): no background, sky,
// depth output or atmosphere.  Otherwise the opaque pass's linear depth
// (before the sphere-depth blend) goes to depth when it is not nullptr.
struct Pixel {
  V3 rd;         // world-space ray
  float depth;   // linear depth after the sphere-depth blend
  float jitter;  // with_atmosphere
  V3 bg;         // SHADE: the background
  float atm[4];  // SHADE and hit: the atmosphere rgba
  bool hit;      // SHADE: the ray hits the atmosphere's shell
};

template <bool EXT>
__device__ __forceinline__ void shade_pixel(const MegakernelParams& p, const float* blue, int x,
                                            int y, bool shade, const float* color, float* depth,
                                            const Sky& sky, bool count, unsigned& n_atmo,
                                            unsigned& n_v1, unsigned& n_sky, unsigned& n_seg,
                                            Pixel& px) {
  const V3 ro = load3(p.cam_pos);
  const V3 pc = load3(p.planet_center);
  const V3 rd = pixel_dir(p, x, y);
  const bool in_rows = x < p.width && y < p.row0 + p.rows;
  const size_t o = (size_t)y * p.width + x;
  px.rd = rd;
  float linear_depth = 1.0e7f;
  V3 b = v3(0.0f, 0.0f, 0.0f);
  if (p.with_background) {
    if (in_rows) {
      if (shade) b = v3(color[o * 3 + 0], color[o * 3 + 1], color[o * 3 + 2]);
      linear_depth = depth[o];
    }
  } else {
    if (p.with_opaque && !opaque_pass<EXT>(p, ro, rd, b, linear_depth) && p.with_sky && shade) {
      b = sky_rgb(sky, rd);
      if (count && in_rows) ++n_sky;
    }
    if (shade && depth && in_rows) depth[o] = linear_depth;
  }
  px.bg = b;
  px.hit = false;
  px.depth = linear_depth;
  if (!p.with_atmosphere) return;  // the opaque-only pass
  float jitter = blue[(y & 255) * 256 + (x & 255)] + p.jitter_offset;
  px.jitter = jitter - floorf(jitter);

  // shell intersection, sphere-depth blend, march span
  float rs0, rs1, g0, g1;
  ray_sphere(pc, p.atmosphere_radius2, ro, rd, rs0, rs1);
  const bool h = rs0 != rs1;
  float t_begin = h ? fmaxf(rs0, 0.0f) : 0.0f;
  float t_end = h ? fmaxf(rs1, 0.0f) : 0.0f;
  ray_sphere(pc, p.planet_radius2, ro, rd, g0, g1);
  const float gd = g0 != g1 ? g0 : 1.0e7f;
  linear_depth = linear_depth + (gd - linear_depth) * p.sphere_depth_factor;
  px.depth = linear_depth;
  t_end = fmaxf(fminf(t_end, linear_depth), t_begin);
  if (shade) {
    px.hit = h;
    if (h) {
      if (p.model == 1) {
        atmosphere_v1(p, ro, rd, t_begin, t_end, px.atm);
        if (count && in_rows) ++n_v1;
      } else {
        unsigned segs = 0;
        atmosphere_v2(p, ro, rd, t_begin, t_end, px.jitter, px.atm, segs);
        if (count && in_rows) {
          ++n_atmo;
          n_seg += segs;
        }
      }
    }
  }
}

// rays, background and atmosphere of the G rows from y0 (shade_pixel),
// and the coarse inputs of their cloud_lod-row coarse pixels
template <bool EXT, int N, int NC>
__device__ __forceinline__ void shade_rows(const MegakernelParams& p, const float* blue, int x,
                                           int y0, int G, int L, RowPix<N>& s, CoarseIn<NC>& ci,
                                           const float* color, float* depth, const Sky& sky,
                                           unsigned long long* work, unsigned& n_atmo,
                                           unsigned& n_v1, unsigned& n_sky, unsigned& n_seg) {
  for (int r = 0; r < G; ++r) {
    Pixel px;
    shade_pixel<EXT>(p, blue, x, y0 + r, true, color, depth, sky, work != nullptr, n_atmo, n_v1,
                     n_sky, n_seg, px);
    s.bg[r] = px.bg;
    s.hit[r] = px.hit;
    if (px.hit) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s.atm[r][c] = px.atm[c];
    }
    if (!p.with_atmosphere) continue;
    const int c = r / L;
    if (r % L == 0) {
      ci.rd_sum[c] = px.rd;
      ci.depth_min[c] = px.depth;
      ci.jit_first[c] = px.jitter;
    } else {
      ci.rd_sum[c] = add(ci.rd_sum[c], px.rd);
      ci.depth_min[c] = fminf(ci.depth_min[c], px.depth);
    }
  }
}

// One coarse pixel: the mean of its L rays, normalized, its shell span
// and whether it sees the cloud layer, and its model-space ray
struct CoarseRay {
  V3 rd_model;
  float tb, tem;  // the march span, clamped to the march distance
  bool vis;
};

__device__ __forceinline__ CoarseRay coarse_ray(const MegakernelParams& p, int L, V3 rd_sum,
                                                float depth_c) {
  const V3 ro = load3(p.cam_pos);
  const V3 pc = load3(p.planet_center);
  const V3 rdm = v3(rd_sum.x / (float)L, rd_sum.y / (float)L, rd_sum.z / (float)L);
  float inv = 1.0f / sqrtf(rdm.x * rdm.x + rdm.y * rdm.y + rdm.z * rdm.z);
  V3 rdc = mul(rdm, inv);
  float top0, top1, bot0, bot1;
  ray_sphere(pc, p.cloud_top_radius2, ro, rdc, top0, top1);
  ray_sphere(pc, p.cloud_bottom_radius2, ro, rdc, bot0, bot1);
  const float t_begin = fmaxf(top0, 0.0f);
  const float t_end = fminf(top1, depth_c);
  CoarseRay c;
  c.vis = (top0 != top1) && (t_begin < depth_c) && ((depth_c > bot1) || (bot0 > 0.0f));
  c.rd_model = xform_dir(p.world_to_model, 4, rdc);
  c.tb = t_begin;
  float te = c.vis ? t_end : t_begin;
  c.tem = t_begin + fminf(te - t_begin, p.march_max_distance);
  return c;
}

// coarse rays, shell spans and visibility per cloud_lod group, and the
// coverage group's knot inputs
template <int N>
__device__ __forceinline__ void coarse_rays(const MegakernelParams& p, int L, int C,
                                            const CoarseIn<N>& ci, Coarse<N>& c) {
  c.any_vis = false;
  for (int k = 0; k < C; ++k) {
    const CoarseRay cr = coarse_ray(p, L, ci.rd_sum[k], ci.depth_min[k]);
    c.vis[k] = cr.vis;
    c.any_vis = c.any_vis || c.vis[k];
    c.rd_model[k] = cr.rd_model;
    c.tb[k] = cr.tb;
    c.tem[k] = cr.tem;
  }
  c.rk = c.rd_model[0];
  c.t0k = c.tb[0];
  c.t1k = c.tem[0];
  if (C > 1) {
    for (int k = 1; k < C; ++k) {
      c.rk = add(c.rk, c.rd_model[k]);
      c.t0k = c.t0k + c.tb[k];
      c.t1k = c.t1k + c.tem[k];
    }
    c.rk = v3(c.rk.x / (float)C, c.rk.y / (float)C, c.rk.z / (float)C);
    c.t0k = c.t0k / (float)C;
    c.t1k = c.t1k / (float)C;
  }
}

// blend each full-resolution row with its group's cloud light/alpha, then
// composite over the background; missed-shell pixels pass through.  A
// chained layer keeps the larger of its alpha and the layers' below.
template <int N>
__device__ __forceinline__ void blend_and_store(const MegakernelParams& p, int x, int y0, int G,
                                                int L, RowPix<N>& s, const bool* vis,
                                                const float* light_c, const float* calpha_c,
                                                float* color, float* alpha_out) {
  if (p.clouds_enabled) {
    for (int r = 0; r < G; ++r) {
      const int c = r / L;
      if (!s.hit[r] || !vis[c]) continue;
      const float la = light_c[c], ca = calpha_c[c];
      float* a = s.atm[r];
      const float sa = 1.0f - ca;
      const float ab = a[3] * sa + ca;
      const float inv = 1.0f / (ab == 0.0f ? 1.0f : ab);
      const float add_a = fmaxf(a[3], ca);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float blended = ab == 0.0f ? 0.0f : (a[k] * (a[3] * sa) + la * ca) * inv;
        float added = a[k] + la * ca;
        a[k] = blended + (added - blended) * p.cloud_blend;
      }
      a[3] = ab + (add_a - ab) * p.cloud_blend;
    }
  }
  if (x >= p.width) return;
  for (int r = 0; r < G; ++r) {
    const int y = y0 + r;
    if (y >= p.row0 + p.rows) break;
    const size_t o = (size_t)y * p.width + x;
    float a_out = 0.0f;
    if (s.hit[r]) {
      const float a = s.atm[r][3];
      color[o * 3 + 0] = s.bg[r].x * (1.0f - a) + s.atm[r][0] * a;
      color[o * 3 + 1] = s.bg[r].y * (1.0f - a) + s.atm[r][1] * a;
      color[o * 3 + 2] = s.bg[r].z * (1.0f - a) + s.atm[r][2] * a;
      a_out = fmaxf(a, 0.0f);
    } else {
      color[o * 3 + 0] = s.bg[r].x;
      color[o * 3 + 1] = s.bg[r].y;
      color[o * 3 + 2] = s.bg[r].z;
    }
    alpha_out[o] = p.with_background ? fmaxf(alpha_out[o], a_out) : a_out;
  }
}

// Optional work counters (nullptr: off): one warp-aggregated atomic per
// category and warp.  chip_smoke.py turns this run's counts into the
// operation count of the roofline bound.
__device__ __forceinline__ void count_work(unsigned long long* work, int slot, unsigned n) {
  const unsigned total = __reduce_add_sync(0xffffffffu, n);
  if ((threadIdx.x & 31) == 0 && total) atomicAdd(work + slot, (unsigned long long)total);
}

// The procedural and texture instances' cycles per stage in the measurement
// build (-DMK_STAGE_CLOCKS): each mark, at a point every lane of the warp
// reaches, adds the warp's clock64 since the last mark to its stage; count
// adds lane 0's sums after the work slots.  Empty in the normal build.
struct StageClock {
#ifdef MK_STAGE_CLOCKS
  long long t;
  unsigned long long c[MK_STAGES];
  __device__ __forceinline__ StageClock() {
    t = clock64();
#pragma unroll
    for (int s = 0; s < MK_STAGES; ++s) c[s] = 0ull;
  }
  __device__ __forceinline__ void mark(int stage) {
    __syncwarp();
    const long long now = clock64();
    c[stage] += (unsigned long long)(now - t);
    t = now;
  }
  __device__ __forceinline__ void count(unsigned long long* work) const {
    if (!work || (threadIdx.x & 31)) return;
#pragma unroll
    for (int s = 0; s < MK_STAGES; ++s) atomicAdd(work + MK_WORK_SLOTS + s, c[s]);
  }
#else
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void count(unsigned long long*) const {}
#endif
};

// the knot position of a coverage group at s in [0, 1], as the plain
// version computes it: ro + rk * lerp(t0k, t1k, s)
__device__ __forceinline__ V3 group_knot_pos(const V3& rom, V3 rk, float t0k, float t1k, float s) {
  return add(rom, mul(rk, t0k + (t1k - t0k) * s));
}

// ---------------------------------------------------------------------------
// The cloud-free frame kernel: one thread per column and row, for a layer
// without clouds and for the opaque-only pass.

template <bool EXT>
__global__ void __launch_bounds__(128) megakernel_clear(const MegakernelParams p,
                                                        const TexParams sky_t,
                                                        const float* __restrict__ blue,
                                                        const float* __restrict__ sky_r,
                                                        const float* __restrict__ sky_g,
                                                        const float* __restrict__ sky_b,
                                                        const int* __restrict__ sky_choices,
                                                        float* __restrict__ color,
                                                        float* __restrict__ alpha_out,
                                                        float* __restrict__ depth,
                                                        unsigned long long* work) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = p.row0 + blockIdx.y;
  const bool live = x < p.width;

  // the sky's choice for the block's tile, as sky_choice_kernel wrote it
  Sky sky{sky_t, sky_r, sky_g, sky_b, TexChoice{MK_WINDOWED, 0}};
  if (p.with_sky) {
    const int tile = blockIdx.y / MK_TILE_ROWS * gridDim.x + blockIdx.x;
    sky.ch = TexChoice{__ldg(sky_choices + 2 * tile), __ldg(sky_choices + 2 * tile + 1)};
  }
  unsigned n_atmo = 0, n_v1 = 0, n_sky = 0, n_seg = 0;
  if (live) {
    RowPix<1> s;
    CoarseIn<1> ci;
    const bool no_clouds = false;
    const float none = 0.0f;
    shade_rows<EXT>(p, blue, x, y, 1, 1, s, ci, color, depth, sky, work, n_atmo, n_v1, n_sky, n_seg);
    blend_and_store(p, x, y, 1, 1, s, &no_clouds, &none, &none, color, alpha_out);
  }
  if (work) {
    count_work(work, p.with_atmosphere ? MK_WORK_PIXELS : MK_WORK_OPAQUE_PIXELS, live ? 1 : 0);
    count_work(work, MK_WORK_ATMOSPHERE, n_atmo);
    count_work(work, MK_WORK_V1_ATMOSPHERE, n_v1);
    count_work(work, MK_WORK_SKY, sky.ch.mode == MK_FLOOR ? 0 : n_sky);
    count_work(work, MK_WORK_SKY_FLOOR, sky.ch.mode == MK_FLOOR ? n_sky : 0);
    count_work(work, MK_WORK_OD_SEGMENTS, n_seg);
  }
}

// ---------------------------------------------------------------------------
// The procedural frame kernel (K1 slice (h)): every procedural config the
// JAX megakernel renders, one instance per C = coverage_lod coarse pixels
// per thread.  One thread per column and per group of G = cloud_lod * C
// rows, G dividing the 32-row tile; a block is 128 columns of one group.
// Shared memory, in rows of one float per thread (gen_layout):
//   * the knots (coverage, shape, detail: any counts), knot-major with a
//     stride of the block's 128 threads;
//   * per coarse pixel of the group, its march inputs (model-space ray,
//     span, jitter), which the march overwrites with its light and alpha;
//   * the row cache, where the block can hold it: each row's atmosphere
//     rgba (alpha -1 where the ray misses the shell).
// Stages (no barrier: a thread reads only what it wrote):
//   1. the coarse pass: every row of the group once (ray, opaque pass or
//      the layers below, sky, atmosphere, linear depth out), its
//      background to the color plane and its atmosphere to the row cache;
//      the coarse pixels' rays and spans;
//   2. the knots of the thread's coverage group, where a coarse pixel sees
//      the cloud layer, and the cull;
//   3. the march of each of the thread's coarse pixels that sees the
//      layer and passes the cull, the fields of its steps inlined;
//   4. each row blended with its coarse pixel's clouds over its
//      background, and stored.
// Without the row cache, stage 1 computes the coarse inputs alone and
// stage 4 shades each row again (two opaque passes per pixel).

// resident blocks per SM its registers are sized for (__launch_bounds__:
// 128 registers; capped for 5 or 6 blocks it spills, and the frames with
// little march or a sun march get slower)
constexpr int gen_min_blocks = 4;

__host__ __device__ __forceinline__ int knot_rows(const MegakernelParams& p) {
  const int shape = p.shape_interp ? (p.shape_knots + 1) * (p.always_low ? 1 : 2) : 0;
  return (p.coverage_interp ? p.coverage_knots + 1 : 0) + shape;
}

// the march inputs of a coarse pixel, rows of the state (the march writes
// its light and alpha over the first two)
constexpr int MK_IN_RX = 0, MK_IN_RY = 1, MK_IN_RZ = 2, MK_IN_TB = 3, MK_IN_TEM = 4, MK_IN_JIT = 5;

template <int C, bool EXT>
__global__ void __launch_bounds__(MK_TILE_COLS, gen_min_blocks)
    megakernel_gen(const __grid_constant__ MegakernelParams p, const TexParams sky_t,
                   const float* __restrict__ blue, const float* __restrict__ sky_r,
                   const float* __restrict__ sky_g, const float* __restrict__ sky_b,
                   const int* __restrict__ sky_choices, float* __restrict__ color,
                   float* __restrict__ alpha_out, float* __restrict__ depth,
                   unsigned long long* work, int row_cache) {
  extern __shared__ float smem[];
  constexpr int T = MK_TILE_COLS;
  const int tid = threadIdx.x;
  const int x = blockIdx.x * T + tid;
  const int L = p.cloud_lod, G = L * C;
  const int y0 = p.row0 + blockIdx.y * G;
  const int n_rows = min(G, p.row0 + p.rows - y0);
  const bool live = x < p.width;
  float* state = smem + knot_rows(p) * T;  // input f of coarse row k at state[(f * C + k) * T]
  float* cache = state + MK_GEN_MARCH_ROWS * C * T;  // rgba c of row r at cache[(r * 4 + c) * T]

  // the sky's choice for the block's tile (G divides the tile height), as
  // sky_choice_kernel wrote it
  Sky sky{sky_t, sky_r, sky_g, sky_b, TexChoice{MK_WINDOWED, 0}};
  if (p.with_sky) {
    const int tile = (blockIdx.y * G) / MK_TILE_ROWS * gridDim.x + blockIdx.x;
    sky.ch = TexChoice{__ldg(sky_choices + 2 * tile), __ldg(sky_choices + 2 * tile + 1)};
  }
  unsigned n_atmo = 0, n_v1 = 0, n_groups = 0, n_march = 0, n_sun = 0, n_sky = 0, n_seg = 0;
  unsigned n_shape_knots = 0, n_detail_knots = 0;
  FieldWork fw{0u, 0u, 0u};
  StageClock clk;

  // 1. the coarse pass: each row once; the coarse pixels' rays and spans,
  // and the coverage group's knot inputs (mean model-space ray, not
  // renormalized, and mean span)
  unsigned vis = 0;  // bit k: coarse pixel k sees the cloud layer
  V3 rk = v3(0.0f, 0.0f, 0.0f);
  float t0k = 0.0f, t1k = 0.0f;
  if (live) {
    for (int k = 0; k < C; ++k) {
      V3 rd_sum = v3(0.0f, 0.0f, 0.0f);
      float depth_min = 0.0f, jit_first = 0.0f;
      for (int l = 0; l < L; ++l) {
        const int r = k * L + l;
        const bool shade = row_cache && r < n_rows;  // a partial last group's other rows
        Pixel px;                                     // only enter its coarse inputs
        shade_pixel<EXT>(p, blue, x, y0 + r, shade, color, depth, sky, work != nullptr, n_atmo, n_v1,
                    n_sky, n_seg, px);
        if (shade) {
          if (!p.with_background) {  // a chained layer's background is in color already
            const size_t o = (size_t)(y0 + r) * p.width + x;
            color[o * 3 + 0] = px.bg.x;
            color[o * 3 + 1] = px.bg.y;
            color[o * 3 + 2] = px.bg.z;
          }
          float* a = cache + r * 4 * T + tid;
          if (px.hit) {
            a[0] = px.atm[0];
            a[T] = px.atm[1];
            a[2 * T] = px.atm[2];
          }
          a[3 * T] = px.hit ? px.atm[3] : -1.0f;
        }
        if (l == 0) {
          rd_sum = px.rd;
          depth_min = px.depth;
          jit_first = px.jitter;
        } else {
          rd_sum = add(rd_sum, px.rd);
          depth_min = fminf(depth_min, px.depth);
        }
      }
      const CoarseRay cr = coarse_ray(p, L, rd_sum, depth_min);
      vis |= (unsigned)cr.vis << k;
      float* in = state + k * T + tid;
      in[MK_IN_RX * C * T] = cr.rd_model.x;
      in[MK_IN_RY * C * T] = cr.rd_model.y;
      in[MK_IN_RZ * C * T] = cr.rd_model.z;
      in[MK_IN_TB * C * T] = cr.tb;
      in[MK_IN_TEM * C * T] = cr.tem;
      in[MK_IN_JIT * C * T] = jit_first;
      rk = k == 0 ? cr.rd_model : add(rk, cr.rd_model);
      t0k = k == 0 ? cr.tb : t0k + cr.tb;
      t1k = k == 0 ? cr.tem : t1k + cr.tem;
    }
    if (C > 1) {
      rk = v3(rk.x / (float)C, rk.y / (float)C, rk.z / (float)C);
      t0k = t0k / (float)C;
      t1k = t1k / (float)C;
    }
  }
  clk.mark(MK_STAGE_COARSE);

  // 2. the coverage group's knots, where a coarse pixel sees the layer
  const V3 rom = load3(p.ro_model);
  const bool full = !p.always_low;
  float cov_max = 0.0f;
  if (vis) {
    float* kn = smem + tid;
    if (p.coverage_interp) {
      const int K = p.coverage_knots;
      for (int k = 0; k <= K; ++k) {
        const float v = field<EXT>(p.coverage, coverage_point(
            p, group_knot_pos(rom, rk, t0k, t1k, (float)((double)k / (double)K))));
        kn[k * T] = v;
        cov_max = k == 0 ? v : fmaxf(cov_max, v);
      }
      kn += (K + 1) * T;
      ++n_groups;
    }
    if (p.shape_interp) {
      const int K = p.shape_knots;
      float* dk = kn + (K + 1) * T;
      for (int k = 0; k <= K; ++k) {
        const V3 pos = group_knot_pos(rom, rk, t0k, t1k, (float)((double)k / (double)K));
        kn[k * T] = field<EXT>(p.shape, mul(pos, p.cloud_shape_scale));
        if (full) dk[k * T] = field<EXT>(p.shape, detail_point(p, pos));
      }
      n_shape_knots += K + 1;
      if (full) n_detail_knots += K + 1;
    }
  }
  // no coverage knots, no bound: every visible coarse pixel marches
  const unsigned marches = (!p.coverage_interp || cloud_may_form(p, cov_max)) ? vis : 0u;
  clk.mark(MK_STAGE_KNOTS);

  // 3. the march of each of the thread's coarse pixels that sees the layer
  // and passes the cull
  {
    float* kn = smem + tid;
    GenKnots cov{nullptr, p.coverage_knots}, shp{nullptr, p.shape_knots},
        det{nullptr, p.shape_knots};
    if (p.coverage_interp) {
      cov.k = kn;
      kn += (cov.K + 1) * T;
    }
    if (p.shape_interp) {
      shp.k = kn;
      det.k = full ? kn + (shp.K + 1) * T : nullptr;
    }
    const GenFields<EXT> fields{cov, shp, det, full, &fw};
    for (int k = 0; k < C; ++k) {
      if (!((marches >> k) & 1u)) continue;
      float* in = state + k * T + tid;
      float light, alpha;
      cloud_march(p, fields, v3(in[MK_IN_RX * C * T], in[MK_IN_RY * C * T], in[MK_IN_RZ * C * T]),
                  in[MK_IN_TB * C * T], in[MK_IN_TEM * C * T], in[MK_IN_JIT * C * T], light,
                  alpha);
      in[0] = light;
      in[C * T] = alpha;
      ++n_march;
      if (p.raymarched_lighting) n_sun += p.cloud_steps * MK_SUN_STEPS;
    }
  }
  clk.mark(MK_STAGE_MARCH);

  // 4. blend each of the group's rows inside the launch with its coarse
  // pixel's clouds, composite over its background, store
  if (live) {
    for (int r = 0; r < n_rows; ++r) {
      const int k = r / L;
      RowPix<1> s;
      if (row_cache) {
        const size_t o = (size_t)(y0 + r) * p.width + x;
        const float* a = cache + r * 4 * T + tid;
        s.bg[0] = v3(color[o * 3 + 0], color[o * 3 + 1], color[o * 3 + 2]);
        s.hit[0] = a[3 * T] >= 0.0f;
        if (s.hit[0]) {
          s.atm[0][0] = a[0];
          s.atm[0][1] = a[T];
          s.atm[0][2] = a[2 * T];
          s.atm[0][3] = a[3 * T];
        }
      } else {
        Pixel px;
        shade_pixel<EXT>(p, blue, x, y0 + r, true, color, depth, sky, work != nullptr, n_atmo, n_v1,
                    n_sky, n_seg, px);
        s.bg[0] = px.bg;
        s.hit[0] = px.hit;
        if (px.hit) {
#pragma unroll
          for (int c = 0; c < 4; ++c) s.atm[0][c] = px.atm[c];
        }
      }
      const bool vis_k = (vis >> k) & 1u, marched = (marches >> k) & 1u;
      const float la = marched ? state[k * T + tid] : 0.0f;
      const float ca = marched ? state[(C + k) * T + tid] : 0.0f;
      blend_and_store(p, x, y0 + r, 1, 1, s, &vis_k, &la, &ca, color, alpha_out);
    }
  }
  clk.mark(MK_STAGE_BLEND);
  if (work) {
    count_work(work, MK_WORK_PIXELS, live ? n_rows : 0);
    count_work(work, MK_WORK_ATMOSPHERE, n_atmo);
    count_work(work, MK_WORK_V1_ATMOSPHERE, n_v1);
    count_work(work, MK_WORK_KNOT_GROUPS, n_groups);
    count_work(work, MK_WORK_MARCH, n_march);
    count_work(work, MK_WORK_SUN_SAMPLES, n_sun);
    count_work(work, MK_WORK_SKY, sky.ch.mode == MK_FLOOR ? 0 : n_sky);
    count_work(work, MK_WORK_SKY_FLOOR, sky.ch.mode == MK_FLOOR ? n_sky : 0);
    count_work(work, MK_WORK_COVERAGE_EVALS, fw.cov);
    count_work(work, MK_WORK_SHAPE_EVALS, fw.shape);
    count_work(work, MK_WORK_DETAIL_EVALS, fw.detail);
    count_work(work, MK_WORK_SHAPE_KNOTS, n_shape_knots);
    count_work(work, MK_WORK_DETAIL_KNOTS, n_detail_knots);
    count_work(work, MK_WORK_OD_SEGMENTS, n_seg);
    // the warp issues march k where any lane marches it
    const unsigned issued = __popc(__reduce_or_sync(0xffffffffu, marches));
    count_work(work, MK_WORK_MARCH_WARP_STEPS,
               (tid & 31) ? 0u : issued * (unsigned)p.cloud_steps);
    count_work(work, MK_WORK_MARCH_LANE_STEPS, n_march * (unsigned)p.cloud_steps);
  }
  clk.count(work);
}

// ---------------------------------------------------------------------------
// Texture mode: K1 with K2 inside.  One thread block per 32 x 128 TPU tile
// (its batches are the TPU kernel's), one thread per column and coverage
// group: 128 x 32 / G threads.  The 9 coverage and 17 shape knots of each
// thread live in dynamic shared memory, knot-major, then block_minmax's
// scratch (per warp, the min and max of up to 3 axes).

constexpr int MK_TEX_KNOT_ROWS = MK_KNOTS + 1 + MK_SHAPE_KNOTS + 1;
constexpr int MK_TEX_RED_SLOTS = 2 * 3;
// resident threads per SM its registers are sized for (64 registers): one
// tile per SM at G = 4, two at G = 8
constexpr int MK_TEX_SM_THREADS = 1024;
__host__ __device__ constexpr int tex_threads(int G) { return MK_TILE_COLS * (MK_TILE_ROWS / G); }
__host__ __device__ constexpr int tex_min_blocks(int G) {
  return MK_TEX_SM_THREADS / tex_threads(G);
}
__host__ __device__ constexpr int tex_smem(int G) {
  return (MK_TEX_KNOT_ROWS * tex_threads(G) + tex_threads(G) / 32 * MK_TEX_RED_SLOTS) *
         (int)sizeof(float);
}

// knot position of a coverage group, as the plain version computes it,
// uncontracted
__device__ __forceinline__ V3 knot_pos(const V3& rom, const Coarse<MK_MAX_GROUP>& c, float s) {
  const float tk = __fadd_rn(c.t0k, __fmul_rn(__fsub_rn(c.t1k, c.t0k), s));
  return v3(__fadd_rn(rom.x, __fmul_rn(c.rk.x, tk)), __fadd_rn(rom.y, __fmul_rn(c.rk.y, tk)),
            __fadd_rn(rom.z, __fmul_rn(c.rk.z, tk)));
}

// coverage direction of a model-space position: the animated xz rotation,
// normalized
__device__ __forceinline__ void coverage_dir(const MegakernelParams& p, V3 pos, float& dx,
                                             float& dy, float& dz) {
  const float qx = __fadd_rn(__fmul_rn(p.coverage_rot[0], pos.x), __fmul_rn(p.coverage_rot[1], pos.z));
  const float qz = __fadd_rn(__fmul_rn(p.coverage_rot[2], pos.x), __fmul_rn(p.coverage_rot[3], pos.z));
  const float qy = pos.y;
  const float inv = rsqrtf(__fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)), __fmul_rn(qz, qz)));
  dx = __fmul_rn(qx, inv);
  dy = __fmul_rn(qy, inv);
  dz = __fmul_rn(qz, inv);
}

// Evaluate one field's K + 1 knots, knot_group knots per batch, into
// knots[k * nt + tid].  SHAPE: the 3D shape texture at pos * shape_scale;
// else the lat-long coverage map.
template <bool SHAPE>
__device__ void eval_knots(const MegakernelParams& p, const TexParams& t,
                           const float* __restrict__ tab, const Coarse<MK_MAX_GROUP>& c, int K,
                           float* knots,
                           float* red, unsigned* n_samples) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  const V3 rom = load3(p.ro_model);
  for (int g0 = 0; g0 <= K; g0 += t.knot_group) {
    const int g1 = min(g0 + t.knot_group, K + 1);
    constexpr int N = SHAPE ? 3 : 2;
    float mn[N], mx[N];
#pragma unroll
    for (int a = 0; a < N; ++a) {
      mn[a] = 3.0e38f;
      mx[a] = -3.0e38f;
    }
    for (int k = g0; k < g1; ++k) {
      const V3 pos = knot_pos(rom, c, (float)((double)k / (double)K));
      float f[N];
      if (SHAPE) {
        f[0] = wrap01(pos.x * p.cloud_shape_scale);
        f[1] = wrap01(pos.y * p.cloud_shape_scale);
        f[N - 1] = wrap01(pos.z * p.cloud_shape_scale);
      } else {
        float dx, dy, dz;
        coverage_dir(p, pos, dx, dy, dz);
        latlong_uv(dx, dy, dz, f[0], f[N - 1]);
      }
#pragma unroll
      for (int a = 0; a < N; ++a) {
        mn[a] = fminf(mn[a], f[a]);
        mx[a] = fmaxf(mx[a], f[a]);
      }
    }
    block_minmax<N>(mn, mx, red);
    const TexChoice ch = SHAPE ? tex3d_choose(t, mn, mx)
                               : latlong_choose(t, mn[0], mx[0], mn[N - 1], mx[N - 1]);
    for (int k = g0; k < g1; ++k) {
      const V3 pos = knot_pos(rom, c, (float)((double)k / (double)K));
      float value;
      if (SHAPE) {
        value = tex3d_sample(t, tab, ch, wrap01(pos.x * p.cloud_shape_scale),
                             wrap01(pos.y * p.cloud_shape_scale),
                             wrap01(pos.z * p.cloud_shape_scale));
      } else {
        float dx, dy, dz, fu, v;
        coverage_dir(p, pos, dx, dy, dz);
        latlong_uv(dx, dy, dz, fu, v);
        value = latlong_sample(t, tab, ch, fu, v);
      }
      knots[k * nt + tid] = value;
    }
    n_samples[ch.mode == MK_FLOOR] += g1 - g0;
  }
}

template <int K, int KS, int G, bool EXT>
__global__ void __launch_bounds__(tex_threads(G), tex_min_blocks(G))
    megakernel_tex(const MegakernelParams p, const TexParams t, const TexParams sky_t,
                   const float* __restrict__ blue, const float* __restrict__ shape_tab,
                   const float* __restrict__ cov_tab, const float* __restrict__ sky_r,
                   const float* __restrict__ sky_g, const float* __restrict__ sky_b,
                   float* __restrict__ color, float* __restrict__ alpha_out,
                   float* __restrict__ depth, unsigned long long* work) {
  extern __shared__ float smem[];
  const int nt = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  float* cov_knots = smem;                    // (K + 1) * nt
  float* shp_knots = smem + (K + 1) * nt;     // (KS + 1) * nt
  float* red = smem + (K + KS + 2) * nt;      // block_minmax scratch

  const int x = blockIdx.x * MK_TILE_COLS + threadIdx.x;
  const int y0 = p.row0 + blockIdx.y * MK_TILE_ROWS + threadIdx.y * G;
  const int L = p.cloud_lod;
  const int C = G / L;

  StageClock clk;
  // the sky's choice: the block's rays are its tile's
  Sky sky{sky_t, sky_r, sky_g, sky_b, TexChoice{MK_WINDOWED, 0}};
  if (p.with_sky) sky.ch = sky_choice<G>(p, sky_t, x, y0, red);
  RowPix<MK_MAX_GROUP> s;
  CoarseIn<MK_MAX_GROUP> ci;
  unsigned n_atmo = 0, n_v1 = 0, n_march = 0, n_sun = 0, n_sky = 0, n_seg = 0,
           tex_samples[2] = {0, 0}, cov_samples[2] = {0, 0};
  shade_rows<EXT>(p, blue, x, y0, G, L, s, ci, color, depth, sky, work, n_atmo, n_v1, n_sky, n_seg);
  Coarse<MK_MAX_GROUP> c;
  coarse_rays(p, L, C, ci, c);
  clk.mark(MK_STAGE_COARSE);

  float light_c[MK_MAX_GROUP], calpha_c[MK_MAX_GROUP];
  for (int k = 0; k < C; ++k) light_c[k] = calpha_c[k] = 0.0f;
  // the tile's gate (clouds.py:573): no visible pixel, no knots, no march
  const bool tile_vis = __syncthreads_or(c.any_vis);
  bool marches = false;
  if (tile_vis) {
    eval_knots<false>(p, t, cov_tab, c, K, cov_knots, red, cov_samples);
    eval_knots<true>(p, t, shape_tab, c, KS, shp_knots, red, tex_samples);
    float cov_max = cov_knots[tid];
    for (int k = 1; k <= K; ++k) cov_max = fmaxf(cov_max, cov_knots[k * nt + tid]);
    marches = c.any_vis && cloud_may_form(p, cov_max);
  }
  clk.mark(MK_STAGE_KNOTS);
  if (marches) {
    const TexFields<K, KS> fields{SmemKnots<K>{cov_knots + tid, nt},
                                  SmemKnots<KS>{shp_knots + tid, nt}};
    for (int k = 0; k < C; ++k) {
      if (c.vis[k]) {
        cloud_march(p, fields, c.rd_model[k], c.tb[k], c.tem[k], ci.jit_first[k], light_c[k],
                    calpha_c[k]);
        ++n_march;
        if (p.raymarched_lighting) n_sun += p.cloud_steps * MK_SUN_STEPS;
      }
    }
  }
  clk.mark(MK_STAGE_MARCH);
  blend_and_store(p, x, y0, G, L, s, c.vis, light_c, calpha_c, color, alpha_out);
  clk.mark(MK_STAGE_BLEND);
  if (work) {
    count_work(work, MK_WORK_PIXELS, x < p.width ? max(0, min(G, p.row0 + p.rows - y0)) : 0);
    count_work(work, MK_WORK_ATMOSPHERE, n_atmo);
    count_work(work, MK_WORK_V1_ATMOSPHERE, n_v1);
    count_work(work, MK_WORK_KNOT_GROUPS, tile_vis ? 1 : 0);
    count_work(work, MK_WORK_MARCH, n_march);
    count_work(work, MK_WORK_SUN_SAMPLES, n_sun);
    count_work(work, MK_WORK_TEX3D, tex_samples[0]);
    count_work(work, MK_WORK_TEX3D_FLOOR, tex_samples[1]);
    count_work(work, MK_WORK_LATLONG, cov_samples[0]);
    count_work(work, MK_WORK_LATLONG_FLOOR, cov_samples[1]);
    count_work(work, MK_WORK_SKY, sky.ch.mode == MK_FLOOR ? 0 : n_sky);
    count_work(work, MK_WORK_SKY_FLOOR, sky.ch.mode == MK_FLOOR ? n_sky : 0);
    count_work(work, MK_WORK_OD_SEGMENTS, n_seg);
  }
  clk.count(work);
}

// ---------------------------------------------------------------------------
// Texture mode, every other config (megakernel_tex_general, K1 slice (i)):
// a baked field beside a procedural one, full quality (the detail knots),
// any coverage and shape knot count, any knot group, any LOD group of G =
// cloud_lod * coverage_lod rows dividing the 32-row tile.  The fixed
// instance above keeps the demo's profile (K = 8, KS = 16, both fields
// baked, low quality, G = 4 or 8); this one takes the rest of the JAX
// kernel's envelope (_check_config, megakernel.py:468-496).
//
// What is hard: a knot batch's mip level and mode come from its knots'
// coordinates over the whole 32 x 128 tile, so the choice needs every
// coverage group of the tile first, and at G = 1 a tile is 4,096 groups.
// What bounds it is what bounds the other instances: issue and latency in
// the per-pixel opaque pass and atmosphere (square roots, divisions, expf),
// the march, and a mixed layer's procedural noise.  So the tile's work is
// separated from the group's, in two launches on the frame's stream:
//   * the tile pass (tex_choice_kernel), one block of 128 x R threads per
//     tile (R = 4, or the tile's rows of groups where fewer), registers for
//     two blocks per SM: where the launch draws the sky, its choice first;
//     then each thread's groups, every row shaded once (the background to
//     the color plane, the atmosphere to a scratch) with its coarse inputs
//     (rows and columns past the frame too: they belong to the tile), each
//     coarse pixel's march inputs to the scratch, the group's knot inputs
//     into shared memory (5 floats); then per knot batch of a baked field
//     the min and max of its coordinates over the thread's groups, the
//     warp's lanes by shuffles and, after one barrier per MK_TEXG_CHUNK
//     batches, the block's warps, one thread per batch finishing; a
//     (mode, level) pair per slot (the sky's, each batch's) and tile to a
//     device buffer (min and max are exact in any order: each choice is
//     the one-block design's bit for bit);
//   * the frame (megakernel_tex_general): one 128-thread block per 128
//     columns of one group row, no barrier: the group's march inputs from
//     the scratch, its knots (a baked field's sampled with its tile's
//     batch choice, a procedural field's evaluated), the march (a per-step
//     field's noise inlined), the blend.
// A pixel's opaque pass and atmosphere run once, at 32 warps per SM; the
// design it replaces ran the opaque pass three times in one 512-thread
// block per tile at 16 warps per SM.  On an H100 at 700 W the 1080p texture
// reference profile (G = 1) takes 1.31 ms against 1.70 before, full
// quality 0.84 (1.02), the mixed layers 1.12 (1.28) and 1.43 (1.71), the
// tile pass 0.31-0.45 of each (compare_megakernel.py, PERF.md).  Measured
// and not kept: the frame shading each row itself (megakernel_gen's row
// cache, the issue's suggestion): its coarse pass at 16-24 warps per SM
// left the mixed layer 0.3-3.6 % slower than before.

// the tile pass: thread rows per tile at most, the floats kept per coverage
// group (its knot inputs: rk.xyz, t0k, t1k), the knot batches reduced per
// barrier; a slot without a choice (the sky's where the launch draws none)
// holds MK_NO_CHOICE twice
constexpr int MK_TEXG_CHOICE_ROWS = 4;
constexpr int MK_TEXG_GROUP_FLOATS = 5;
constexpr int MK_TEXG_CHUNK = 32;
constexpr int MK_NO_CHOICE = -1;

// the knot rows a thread holds: each field's K + 1 knots where it has
// knots, the detail field's beside the shape field's at full quality
__host__ __device__ __forceinline__ int texg_knot_rows(const MegakernelParams& p,
                                                       const TexParams& t) {
  const int shape = t.shape_source == MK_SRC_STEP ? 0 : (p.shape_knots + 1) * (p.always_low ? 1 : 2);
  return (t.cov_source == MK_SRC_STEP ? 0 : p.coverage_knots + 1) + shape;
}

// the knot batches whose level and mode the tile pass chooses: a baked
// field's K + 1 knots, knot_group at a time (the detail field's too)
__host__ __device__ __forceinline__ int texg_batches(const MegakernelParams& p, const TexParams& t) {
  const int kg = t.knot_group;
  int n = t.cov_source == MK_SRC_PYRAMID ? (p.coverage_knots + kg) / kg : 0;
  if (t.shape_source == MK_SRC_PYRAMID) n += (p.shape_knots + kg) / kg * (p.always_low ? 1 : 2);
  return n;
}

// a field's knots: 0 coverage, 1 shape, 2 detail; whether it has knots and
// whether they come from a pyramid
__device__ __forceinline__ bool texg_has_knots(const MegakernelParams& p, const TexParams& t,
                                               int fld) {
  if (fld == 0) return t.cov_source != MK_SRC_STEP;
  return t.shape_source != MK_SRC_STEP && (fld == 1 || !p.always_low);
}
__device__ __forceinline__ bool texg_baked(const TexParams& t, int fld) {
  return (fld == 0 ? t.cov_source : t.shape_source) == MK_SRC_PYRAMID;
}

// knot position of a coverage group at s, as the plain version computes
// it, uncontracted
__device__ __forceinline__ V3 texg_knot_pos(const V3& rom, const float* g, float s) {
  const float tk = __fadd_rn(g[3], __fmul_rn(__fsub_rn(g[4], g[3]), s));
  return v3(__fadd_rn(rom.x, __fmul_rn(g[0], tk)), __fadd_rn(rom.y, __fmul_rn(g[1], tk)),
            __fadd_rn(rom.z, __fmul_rn(g[2], tk)));
}

// a baked field's sampler coordinates at a knot position: the lat-long
// (fu, v) of the coverage direction (f[2] = 0), or the wrapped 3D texture
// coordinates of the shape field (pos * shape_scale) or of the detail field
// (pos * 15 + time * 0.01, clouds.py::detail_position)
__device__ __forceinline__ void texg_coords(const MegakernelParams& p, int fld, V3 pos,
                                            float f[3]) {
  if (fld == 0) {
    float dx, dy, dz;
    coverage_dir(p, pos, dx, dy, dz);
    latlong_uv(dx, dy, dz, f[0], f[1]);
    f[2] = 0.0f;
  } else if (fld == 1) {
    f[0] = wrap01(pos.x * p.cloud_shape_scale);
    f[1] = wrap01(pos.y * p.cloud_shape_scale);
    f[2] = wrap01(pos.z * p.cloud_shape_scale);
  } else {
    const float tm = p.time * 0.01f;
    f[0] = wrap01(__fadd_rn(__fmul_rn(pos.x, 15.0f), tm));
    f[1] = wrap01(__fadd_rn(__fmul_rn(pos.y, 15.0f), tm));
    f[2] = wrap01(__fadd_rn(__fmul_rn(pos.z, 15.0f), tm));
  }
}

// The general texture instance's fields in the march: each from its knots
// in shared memory (stride of the block's 128 threads), or from its procedural spec per
// step and per sun sample; at full quality the detail field, whose sun
// samples take it only where the march's alpha is below 0.3 (as GenFields).
// Knots interpolate uncontracted, as the fixed instance's do.
template <bool EXT>
struct TexGenFields {
  const float* cov_k;  // knot j at cov_k[j * stride]; nullptr: per step
  const float* shp_k;
  const float* det_k;
  int K, KS, stride;
  bool full;
  FieldWork* work;
  __device__ __forceinline__ float interp(const float* k, int n, float u01) const {
    const float us = u01 * (float)n;
    const float i0 = fminf(fmaxf(floorf(us), 0.0f), (float)(n - 1));
    const int seg = (int)i0;
    const float f = us - i0;
    return __fadd_rn(__fmul_rn(k[seg * stride], 1.0f - f), __fmul_rn(k[(seg + 1) * stride], f));
  }
  __device__ __forceinline__ float cov_at(const MegakernelParams& p, V3 pos) const {
    ++work->cov;
    return march_field<EXT>(p.coverage, coverage_point(p, pos));
  }
  __device__ __forceinline__ float shape_at(const MegakernelParams& p, V3 pos) const {
    ++work->shape;
    return march_field<EXT>(p.shape, mul(pos, p.cloud_shape_scale));
  }
  __device__ __forceinline__ float detail_at(const MegakernelParams& p, V3 pos) const {
    ++work->detail;
    return march_field<EXT>(p.shape, detail_point(p, pos));
  }
  __device__ __forceinline__ float cov(const MegakernelParams& p, float u01, V3 pos) const {
    return cov_k ? interp(cov_k, K, u01) : cov_at(p, pos);
  }
  __device__ __forceinline__ float shape(const MegakernelParams& p, float u01, V3 pos) const {
    return shp_k ? interp(shp_k, KS, u01) : shape_at(p, pos);
  }
  __device__ __forceinline__ float detail(const MegakernelParams& p, float u01, V3 pos) const {
    if (!full) return 0.5f;
    return det_k ? interp(det_k, KS, u01) : detail_at(p, pos);
  }
  __device__ __forceinline__ float sun_cov(const MegakernelParams& p, float c, V3 pos) const {
    return cov_k ? c : cov_at(p, pos);
  }
  __device__ __forceinline__ float sun_shape(const MegakernelParams& p, float s, V3 pos) const {
    return shp_k ? s : shape_at(p, pos);
  }
  __device__ __forceinline__ float sun_detail(const MegakernelParams& p, float d, V3 pos,
                                              float alpha0) const {
    if (!full || !(alpha0 < 0.3f)) return 0.5f;
    return det_k ? d : detail_at(p, pos);
  }
};

// The general instance's scratch between its two launches (device memory
// the launcher is given): each row's atmosphere rgba (alpha -1 where the ray
// misses the shell), by launch row and column, and each coarse pixel's march
// inputs (MK_IN_* rows) and visibility (MK_TEXG_IN_VIS), by coarse row of
// the launch's groups and column.
constexpr int MK_TEXG_IN_VIS = MK_GEN_MARCH_ROWS;
constexpr int MK_TEXG_IN_PLANES = MK_GEN_MARCH_ROWS + 1;
struct TexgScratch {
  float* atm;       // row y, column x: atm[((y - row0) * width + x) * 4 + c]
  float* march;     // input f of coarse row cr, column x: march[(f * coarse_rows + cr) * width + x]
  int coarse_rows;  // the launch's groups' coarse rows: ceil(rows / G) * C
};

__host__ __device__ __forceinline__ int texg_coarse_rows(const MegakernelParams& p) {
  const int G = p.cloud_lod * p.coverage_lod;
  return (p.rows + G - 1) / G * p.coverage_lod;
}
__host__ __device__ __forceinline__ long texg_scratch_floats(const MegakernelParams& p) {
  return ((long)p.rows * 4 + (long)MK_TEXG_IN_PLANES * texg_coarse_rows(p)) * p.width;
}

// The tile pass for the group of G rows from y0 in column x: each row
// inside the launch shaded once (ray, opaque pass or the layers below, sky,
// atmosphere, linear depth out), its background to the color plane (a
// chained layer's is there already) and its atmosphere to the scratch; every
// row's coarse inputs, rows and columns past the launch included (they
// belong to the tile); the coarse pixels' march inputs to the scratch where
// the frame marches the group.  Returns the group's knot inputs in g[0..4].
template <bool EXT>
__device__ __forceinline__ void texg_shade_group(const MegakernelParams& p, const float* blue,
                                                 int x, int y0, float* color, float* depth,
                                                 const Sky& sky, const TexgScratch& sc,
                                                 bool count, unsigned& n_atmo, unsigned& n_v1,
                                                 unsigned& n_sky, unsigned& n_seg,
                                                 float g[MK_TEXG_GROUP_FLOATS]) {
  const int L = p.cloud_lod, C = p.coverage_lod;
  const bool live = x < p.width, marched = live && y0 < p.row0 + p.rows;
  V3 rk = v3(0.0f, 0.0f, 0.0f);
  float t0k = 0.0f, t1k = 0.0f;
  for (int k = 0; k < C; ++k) {
    V3 rd_sum = v3(0.0f, 0.0f, 0.0f);
    float depth_min = 0.0f, jit_first = 0.0f;
    for (int l = 0; l < L; ++l) {
      const int y = y0 + k * L + l;
      const bool shade = live && y < p.row0 + p.rows;
      Pixel px;
      shade_pixel<EXT>(p, blue, x, y, shade, color, depth, sky, count, n_atmo, n_v1, n_sky, n_seg,
                       px);
      if (shade) {
        const size_t o = (size_t)y * p.width + x;
        if (!p.with_background) {
          color[o * 3 + 0] = px.bg.x;
          color[o * 3 + 1] = px.bg.y;
          color[o * 3 + 2] = px.bg.z;
        }
        float* a = sc.atm + ((size_t)(y - p.row0) * p.width + x) * 4;
        if (px.hit) {
          a[0] = px.atm[0];
          a[1] = px.atm[1];
          a[2] = px.atm[2];
        }
        a[3] = px.hit ? px.atm[3] : -1.0f;
      }
      if (l == 0) {
        rd_sum = px.rd;
        depth_min = px.depth;
        jit_first = px.jitter;
      } else {
        rd_sum = add(rd_sum, px.rd);
        depth_min = fminf(depth_min, px.depth);
      }
    }
    const CoarseRay cr = coarse_ray(p, L, rd_sum, depth_min);
    if (marched) {
      const size_t plane = (size_t)sc.coarse_rows * p.width;
      float* in = sc.march + (size_t)((y0 - p.row0) / L + k) * p.width + x;
      in[MK_IN_RX * plane] = cr.rd_model.x;
      in[MK_IN_RY * plane] = cr.rd_model.y;
      in[MK_IN_RZ * plane] = cr.rd_model.z;
      in[MK_IN_TB * plane] = cr.tb;
      in[MK_IN_TEM * plane] = cr.tem;
      in[MK_IN_JIT * plane] = jit_first;
      in[MK_TEXG_IN_VIS * plane] = cr.vis ? 1.0f : 0.0f;
    }
    rk = k == 0 ? cr.rd_model : add(rk, cr.rd_model);
    t0k = k == 0 ? cr.tb : t0k + cr.tb;
    t1k = k == 0 ? cr.tem : t1k + cr.tem;
  }
  if (C > 1) {
    rk = v3(rk.x / (float)C, rk.y / (float)C, rk.z / (float)C);
    t0k = t0k / (float)C;
    t1k = t1k / (float)C;
  }
  g[0] = rk.x;
  g[1] = rk.y;
  g[2] = rk.z;
  g[3] = t0k;
  g[4] = t1k;
}

// the tile pass's choice slots per tile: the sky's, then each knot batch's
__host__ __device__ __forceinline__ int texg_choice_slots(const MegakernelParams& p,
                                                          const TexParams& t) {
  return 1 + texg_batches(p, t);
}

// knot batch b's field (0 coverage, 1 shape, 2 detail), its knot count K
// and its first knot, in the order of texg_batches
__device__ __forceinline__ void texg_batch(const MegakernelParams& p, const TexParams& t, int b,
                                           int& fld, int& K, int& k0) {
  for (fld = 0; fld < 3; ++fld) {
    if (!texg_has_knots(p, t, fld) || !texg_baked(t, fld)) continue;
    K = fld == 0 ? p.coverage_knots : p.shape_knots;
    const int n = K / t.knot_group + 1;
    if (b < n) {
      k0 = b * t.knot_group;
      return;
    }
    b -= n;
  }
}

// the warp's min and max of N values per lane; every lane receives them
template <int N>
__device__ __forceinline__ void warp_minmax(float (&mn)[N], float (&mx)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn[k] = fminf(mn[k], __shfl_xor_sync(0xffffffffu, mn[k], off));
      mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], off));
    }
  }
}

// one ray of the sky's choice: its lat-long (fu, v) into the thread's min
// and max
__device__ __forceinline__ void sky_ray_minmax(const MegakernelParams& p, int x, int y,
                                               float (&mn)[2], float (&mx)[2]) {
  const V3 rd = pixel_dir(p, x, y);
  float fu, v;
  latlong_uv(rd.x, rd.y, rd.z, fu, v);
  mn[0] = fminf(mn[0], fu);
  mx[0] = fmaxf(mx[0], fu);
  mn[1] = fminf(mn[1], v);
  mx[1] = fmaxf(mx[1], v);
}

// The sky's choice over a block of nw <= 32 warps from each thread's min
// and max (tid: the thread's index in the block): the warp's lanes by
// shuffles, one barrier, then the first warp's lanes take one warp's
// partials each (part: 4 floats per warp) and reduce them by shuffles.
// The first warp returns the choice; every other thread MK_NO_CHOICE.
__device__ __forceinline__ TexChoice sky_block_choice(const TexParams& sky_t, float (&mn)[2],
                                                      float (&mx)[2], float* part, int tid,
                                                      int nw) {
  warp_minmax<2>(mn, mx);
  if ((tid & 31) == 0) {
    float* w = part + (tid >> 5) * 4;
    w[0] = mn[0];
    w[1] = mn[1];
    w[2] = mx[0];
    w[3] = mx[1];
  }
  __syncthreads();
  if (tid >= 32) return TexChoice{MK_NO_CHOICE, MK_NO_CHOICE};
  const float* w = part + (tid < nw ? tid : 0) * 4;
  mn[0] = w[0];
  mn[1] = w[1];
  mx[0] = w[2];
  mx[1] = w[3];
  warp_minmax<2>(mn, mx);
  return latlong_choose(sky_t, mn[0], mx[0], mn[1], mx[1]);
}

// The general texture instance's tile pass: one block of 128 x R threads
// per 32 x 128 tile of the launch's grid (from row0), rows and columns past
// the frame included; registers sized for two blocks per SM.  Where the
// launch draws the sky, its choice comes first (every ray of the tile).
// Then each thread's groups (texg_shade_group; their knot inputs into
// shared memory) and, per choice slot, the min and max over the tile.
// choices[(tile * slots + s) * 2] gets slot s's (mode, level), tiles
// row-major: slot 0 the sky's (MK_NO_CHOICE without one), then each knot
// batch's (texg_batch).
template <bool EXT>
__global__ void __launch_bounds__(MK_TILE_COLS * MK_TEXG_CHOICE_ROWS, 2)
    tex_choice_kernel(const __grid_constant__ MegakernelParams p, const TexParams t,
                      const TexParams sky_t, const float* __restrict__ blue,
                      const float* __restrict__ sky_r, const float* __restrict__ sky_g,
                      const float* __restrict__ sky_b, float* __restrict__ color,
                      float* __restrict__ depth, const TexgScratch sc, int* __restrict__ choices,
                      unsigned long long* work) {
  extern __shared__ float smem[];
  __shared__ int sky_choice[2];
  constexpr int T = MK_TILE_COLS;
  const int R = blockDim.y, tx = threadIdx.x, tid = threadIdx.y * T + tx;
  const int lane = tid & 31, warp = tid >> 5, nw = R * (T / 32);
  const int G = p.cloud_lod * p.coverage_lod, NGR = MK_TILE_ROWS / G;
  const int x = blockIdx.x * T + tx;
  const int tile_y0 = p.row0 + blockIdx.y * MK_TILE_ROWS;
  const int slots = texg_choice_slots(p, t);
  int* out = choices + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * slots * 2;
  float* groups = smem;  // value f of group row gr at groups[(f * NGR + gr) * T + tx]
  float* part = groups + MK_TEXG_GROUP_FLOATS * NGR * T;  // slot s, warp w: part[(s * nw + w) * 6]
  const V3 rom = load3(p.ro_model);
  StageClock clk;

  // the sky's choice: the min and max of (fu, v) over the tile's rays
  Sky sky{sky_t, sky_r, sky_g, sky_b, TexChoice{MK_NO_CHOICE, MK_NO_CHOICE}};
  if (p.with_sky) {
    float mn[2] = {3.0e38f, 3.0e38f}, mx[2] = {-3.0e38f, -3.0e38f};
    for (int gr = threadIdx.y; gr < NGR; gr += R)
      for (int r = 0; r < G; ++r) sky_ray_minmax(p, x, tile_y0 + gr * G + r, mn, mx);
    const TexChoice ch = sky_block_choice(sky_t, mn, mx, part, tid, nw);
    if (tid == 0) {
      sky_choice[0] = ch.mode;
      sky_choice[1] = ch.level;
    }
    __syncthreads();
    sky.ch = TexChoice{sky_choice[0], sky_choice[1]};
  }
  if (tid == 0) {
    out[0] = sky.ch.mode;
    out[1] = sky.ch.level;
  }

  // A. the thread's groups: each row shaded once, the coarse inputs, the
  // march inputs, the knot inputs
  unsigned n_atmo = 0, n_v1 = 0, n_sky = 0, n_seg = 0;
  for (int gr = threadIdx.y; gr < NGR; gr += R) {
    float g[MK_TEXG_GROUP_FLOATS];
    texg_shade_group<EXT>(p, blue, x, tile_y0 + gr * G, color, depth, sky, sc, work != nullptr, n_atmo,
                     n_v1, n_sky, n_seg, g);
#pragma unroll
    for (int f = 0; f < MK_TEXG_GROUP_FLOATS; ++f) groups[(f * NGR + gr) * T + tx] = g[f];
  }
  if (work) {
    count_work(work, MK_WORK_ATMOSPHERE, n_atmo);
    count_work(work, MK_WORK_V1_ATMOSPHERE, n_v1);
    count_work(work, MK_WORK_SKY, sky.ch.mode == MK_FLOOR ? 0 : n_sky);
    count_work(work, MK_WORK_SKY_FLOOR, sky.ch.mode == MK_FLOOR ? n_sky : 0);
    count_work(work, MK_WORK_OD_SEGMENTS, n_seg);
  }
  clk.mark(MK_STAGE_CHOICE_COARSE);

  // B. per knot batch, the min and max over the tile: the thread's groups,
  // the warp's lanes, then (after one barrier per chunk of batches) the
  // block's warps, one thread per batch
  for (int s0 = 1; s0 < slots; s0 += MK_TEXG_CHUNK) {
    const int s1 = min(s0 + MK_TEXG_CHUNK, slots);
    if (s0 > 1) __syncthreads();  // the last chunk's partials are read
    for (int s = s0; s < s1; ++s) {
      float mn[3] = {3.0e38f, 3.0e38f, 3.0e38f}, mx[3] = {-3.0e38f, -3.0e38f, -3.0e38f};
      int fld, K, k0;
      texg_batch(p, t, s - 1, fld, K, k0);
      const int k1 = min(k0 + t.knot_group, K + 1);
      for (int k = k0; k < k1; ++k) {
        const float sk = (float)((double)k / (double)K);  // the knot's, for every group
        for (int gr = threadIdx.y; gr < NGR; gr += R) {
          float g[MK_TEXG_GROUP_FLOATS];
#pragma unroll
          for (int f = 0; f < MK_TEXG_GROUP_FLOATS; ++f) g[f] = groups[(f * NGR + gr) * T + tx];
          float c[3];
          texg_coords(p, fld, texg_knot_pos(rom, g, sk), c);
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            mn[a] = fminf(mn[a], c[a]);
            mx[a] = fmaxf(mx[a], c[a]);
          }
        }
      }
      warp_minmax<3>(mn, mx);
      if (lane == 0) {
        float* w = part + ((s - s0) * nw + warp) * 6;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          w[a] = mn[a];
          w[3 + a] = mx[a];
        }
      }
    }
    __syncthreads();
    if (tid < s1 - s0) {
      const int s = s0 + tid;
      float mn[3], mx[3];
      const float* w = part + tid * nw * 6;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        mn[a] = w[a];
        mx[a] = w[3 + a];
      }
      for (int v = 1; v < nw; ++v) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          mn[a] = fminf(mn[a], w[v * 6 + a]);
          mx[a] = fmaxf(mx[a], w[v * 6 + 3 + a]);
        }
      }
      int fld, K, k0;
      texg_batch(p, t, s - 1, fld, K, k0);
      const TexChoice ch =
          fld == 0 ? latlong_choose(t, mn[0], mx[0], mn[1], mx[1]) : tex3d_choose(t, mn, mx);
      out[2 * s] = ch.mode;
      out[2 * s + 1] = ch.level;
    }
  }
  clk.mark(MK_STAGE_CHOICE);
  clk.count(work);
}


// What the general texture instance's frame knows of its group after its
// first stage: which of its coarse pixels see the cloud layer (bit k) and
// the group's knot inputs (mean model-space ray, not renormalized, and mean
// span).
struct GroupInputs {
  unsigned vis;
  V3 rk;
  float t0k, t1k;
};

// Stage 2 of the general texture instance: the coverage group's knots,
// where a coarse pixel sees the layer, into the thread's knot rows (kn, a
// stride of the block); a baked field's sampled with its batch's choice
// (batch: the tile's batch slots of the tile pass), a procedural field's
// evaluated.  Returns the coarse pixels that march (no coverage knots, no
// bound: every visible one).
template <bool EXT>
__device__ __forceinline__ unsigned texg_knots(const MegakernelParams& p, const TexParams& t,
                                               const float* __restrict__ shape_tab,
                                               const float* __restrict__ cov_tab,
                                               const int* __restrict__ batch,
                                               const GroupInputs& gi, float* kn,
                                               unsigned& n_groups, unsigned& n_shape_knots,
                                               unsigned& n_detail_knots, unsigned* tex_samples,
                                               unsigned* cov_samples) {
  constexpr int T = MK_TILE_COLS;
  if (!gi.vis) return 0u;
  const V3 rom = load3(p.ro_model);
  const float g[MK_TEXG_GROUP_FLOATS] = {gi.rk.x, gi.rk.y, gi.rk.z, gi.t0k, gi.t1k};
  int b = 0, row = 0;
  float cov_max = 0.0f;
  for (int fld = 0; fld < 3; ++fld) {
    if (!texg_has_knots(p, t, fld)) continue;
    const bool baked = texg_baked(t, fld);
    const int K = fld == 0 ? p.coverage_knots : p.shape_knots;
    float* k_row = kn + row * T;
    for (int k = 0; k <= K; ++k) {
      const V3 pos = texg_knot_pos(rom, g, (float)((double)k / (double)K));
      float value;
      if (baked) {
        const int bk = b + k / t.knot_group;
        const TexChoice ch{__ldg(batch + 2 * bk), __ldg(batch + 2 * bk + 1)};
        float c[3];
        texg_coords(p, fld, pos, c);
        if (fld == 0) {
          value = latlong_sample(t, cov_tab, ch, c[0], c[1]);
          ++cov_samples[ch.mode == MK_FLOOR];
        } else {
          value = tex3d_sample(t, shape_tab, ch, c[0], c[1], c[2]);
          ++tex_samples[ch.mode == MK_FLOOR];
        }
      } else if (fld == 0) {
        value = field<EXT>(p.coverage, coverage_point(p, pos));
      } else {
        value = field<EXT>(p.shape, fld == 1 ? mul(pos, p.cloud_shape_scale) : detail_point(p, pos));
      }
      k_row[k * T] = value;
      if (fld == 0) cov_max = k == 0 ? value : fmaxf(cov_max, value);
    }
    if (baked) b += K / t.knot_group + 1;
    else if (fld == 1) n_shape_knots += K + 1;
    else if (fld == 2) n_detail_knots += K + 1;
    row += K + 1;
  }
  ++n_groups;
  return (t.cov_source == MK_SRC_STEP || cloud_may_form(p, cov_max)) ? gi.vis : 0u;
}

// The general texture instance's frame: one thread per column and coverage
// group, megakernel_gen's blocks, no barrier.  Stages: the group's march
// inputs from the scratch (the tile pass's) into shared memory; the knots
// (texg_knots, with the block's tile's batch choices); the march
// (TexGenFields); each row blended with its coarse pixel's
// clouds over its background (the color plane) and atmosphere (the
// scratch), and stored.  Its registers are sized for texg_min_blocks
// blocks per SM (80 registers, 48 B of spill stores): against 4 blocks (128,
// no spills) the 1080p texture-envelope frames took 4-14 % less time;
// against 8 (64, 164 B of spills) full quality took 16 % less, the others
// within 2 % either way (an H100 at 700 W; compare_megakernel.py, PERF.md).
constexpr int texg_min_blocks = 6;
template <bool EXT>
__global__ void __launch_bounds__(MK_TILE_COLS, texg_min_blocks)
    megakernel_tex_general(const __grid_constant__ MegakernelParams p, const TexParams t,
                           const float* __restrict__ shape_tab, const float* __restrict__ cov_tab,
                           const int* __restrict__ choices, const TexgScratch sc,
                           float* __restrict__ color, float* __restrict__ alpha_out,
                           unsigned long long* work) {
  extern __shared__ float smem[];
  constexpr int T = MK_TILE_COLS;
  const int tid = threadIdx.x;
  const int x = blockIdx.x * T + tid;
  const int L = p.cloud_lod, C = p.coverage_lod, G = L * C;
  const int y0 = p.row0 + blockIdx.y * G;
  const int n_rows = min(G, p.row0 + p.rows - y0);
  const bool live = x < p.width;
  float* state = smem + texg_knot_rows(p, t) * T;  // input f of coarse row k at state[(f * C + k) * T]
  // the block's tile's knot batch choices (G divides the tile height)
  const int tile = (blockIdx.y * G) / MK_TILE_ROWS * gridDim.x + blockIdx.x;
  const int* batch = choices + ((size_t)tile * texg_choice_slots(p, t) + 1) * 2;
  unsigned n_groups = 0, n_march = 0, n_sun = 0, n_shape_knots = 0, n_detail_knots = 0;
  unsigned tex_samples[2] = {0, 0}, cov_samples[2] = {0, 0};
  FieldWork fw{0u, 0u, 0u};
  const bool full = !p.always_low;
  StageClock clk;

  // 1. the march inputs and, from them, the knot inputs (in the tile pass's
  // order of operations)
  GroupInputs gi{0u, v3(0.0f, 0.0f, 0.0f), 0.0f, 0.0f};
  if (live) {
    const size_t plane = (size_t)sc.coarse_rows * p.width;
    const float* src = sc.march + (size_t)(blockIdx.y * C) * p.width + x;
    for (int k = 0; k < C; ++k) {
      const float* in = src + (size_t)k * p.width;
#pragma unroll
      for (int f = 0; f < MK_GEN_MARCH_ROWS; ++f) state[(f * C + k) * T + tid] = in[f * plane];
      gi.vis |= (unsigned)(in[MK_TEXG_IN_VIS * plane] != 0.0f) << k;
      const V3 rd_model = v3(in[MK_IN_RX * plane], in[MK_IN_RY * plane], in[MK_IN_RZ * plane]);
      gi.rk = k == 0 ? rd_model : add(gi.rk, rd_model);
      gi.t0k = k == 0 ? in[MK_IN_TB * plane] : gi.t0k + in[MK_IN_TB * plane];
      gi.t1k = k == 0 ? in[MK_IN_TEM * plane] : gi.t1k + in[MK_IN_TEM * plane];
    }
    if (C > 1) {
      gi.rk = v3(gi.rk.x / (float)C, gi.rk.y / (float)C, gi.rk.z / (float)C);
      gi.t0k = gi.t0k / (float)C;
      gi.t1k = gi.t1k / (float)C;
    }
  }
  clk.mark(MK_STAGE_COARSE);

  // 2. the knots and the cull
  const unsigned marches = texg_knots<EXT>(p, t, shape_tab, cov_tab, batch, gi, smem + tid, n_groups,
                                      n_shape_knots, n_detail_knots, tex_samples, cov_samples);
  clk.mark(MK_STAGE_KNOTS);

  // 3. the march
  {
    const float* kn = smem + tid;
    const float* cov_k = nullptr;
    const float* shp_k = nullptr;
    const float* det_k = nullptr;
    if (t.cov_source != MK_SRC_STEP) {
      cov_k = kn;
      kn += (p.coverage_knots + 1) * T;
    }
    if (t.shape_source != MK_SRC_STEP) {
      shp_k = kn;
      if (full) det_k = kn + (p.shape_knots + 1) * T;
    }
    const TexGenFields<EXT> fields{cov_k, shp_k, det_k, p.coverage_knots, p.shape_knots, T, full,
                                    &fw};
    // megakernel_gen's stage 3 (shared through one device function, it
    // reordered megakernel_gen's SASS, so each kernel keeps its loop)
    for (int k = 0; k < C; ++k) {
      if (!((marches >> k) & 1u)) continue;
      float* in = state + k * T + tid;
      float light, alpha;
      cloud_march(p, fields, v3(in[MK_IN_RX * C * T], in[MK_IN_RY * C * T], in[MK_IN_RZ * C * T]),
                  in[MK_IN_TB * C * T], in[MK_IN_TEM * C * T], in[MK_IN_JIT * C * T], light,
                  alpha);
      in[0] = light;
      in[C * T] = alpha;
      ++n_march;
      if (p.raymarched_lighting) n_sun += p.cloud_steps * MK_SUN_STEPS;
    }
  }
  clk.mark(MK_STAGE_MARCH);

  // 4. each row inside the launch: its background and atmosphere, blended
  // with its coarse pixel's clouds, stored
  if (live) {
    for (int r = 0; r < n_rows; ++r) {
      const int k = r / L;
      const size_t o = (size_t)(y0 + r) * p.width + x;
      const float* a = sc.atm + ((size_t)(y0 + r - p.row0) * p.width + x) * 4;
      RowPix<1> s;
      s.bg[0] = v3(color[o * 3 + 0], color[o * 3 + 1], color[o * 3 + 2]);
      s.hit[0] = a[3] >= 0.0f;
      if (s.hit[0]) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s.atm[0][c] = a[c];
      }
      const bool vis_k = (gi.vis >> k) & 1u, marched = (marches >> k) & 1u;
      const float la = marched ? state[k * T + tid] : 0.0f;
      const float ca = marched ? state[(C + k) * T + tid] : 0.0f;
      blend_and_store(p, x, y0 + r, 1, 1, s, &vis_k, &la, &ca, color, alpha_out);
    }
  }
  clk.mark(MK_STAGE_BLEND);
  if (work) {
    count_work(work, MK_WORK_PIXELS, live ? n_rows : 0);
    count_work(work, MK_WORK_KNOT_GROUPS, n_groups);
    count_work(work, MK_WORK_MARCH, n_march);
    count_work(work, MK_WORK_SUN_SAMPLES, n_sun);
    count_work(work, MK_WORK_TEX3D, tex_samples[0]);
    count_work(work, MK_WORK_TEX3D_FLOOR, tex_samples[1]);
    count_work(work, MK_WORK_LATLONG, cov_samples[0]);
    count_work(work, MK_WORK_LATLONG_FLOOR, cov_samples[1]);
    count_work(work, MK_WORK_COVERAGE_EVALS, fw.cov);
    count_work(work, MK_WORK_SHAPE_EVALS, fw.shape);
    count_work(work, MK_WORK_DETAIL_EVALS, fw.detail);
    count_work(work, MK_WORK_SHAPE_KNOTS, n_shape_knots);
    count_work(work, MK_WORK_DETAIL_KNOTS, n_detail_knots);
    // the warp issues march k where any lane marches it
    const unsigned issued = __popc(__reduce_or_sync(0xffffffffu, marches));
    count_work(work, MK_WORK_MARCH_WARP_STEPS,
               (tid & 31) ? 0u : issued * (unsigned)p.cloud_steps);
    count_work(work, MK_WORK_MARCH_LANE_STEPS, n_march * (unsigned)p.cloud_steps);
  }
  clk.count(work);
}


// The sky's pre-pass for the procedural instance and the opaque-only pass:
// one block of 128 x MK_SKY_CHOICE_THREADS_Y threads per 32 x 128 tile of
// the launch's grid (from row0), each thread taking MK_SKY_CHOICE_RAYS rows
// of its column, rows and columns past the frame included, then the
// block's choice (sky_block_choice).  It writes the tile's (mode, level) to
// choices[2 * tile], tiles row-major.
__global__ void __launch_bounds__(MK_TILE_COLS * MK_SKY_CHOICE_THREADS_Y)
    sky_choice_kernel(const MegakernelParams p, const TexParams sky_t, int* __restrict__ choices) {
  constexpr int NW = MK_TILE_COLS * MK_SKY_CHOICE_THREADS_Y / 32;
  __shared__ float part[NW * 4];
  const int tid = threadIdx.y * MK_TILE_COLS + threadIdx.x;
  const int x = blockIdx.x * MK_TILE_COLS + threadIdx.x;
  const int y0 = p.row0 + blockIdx.y * MK_TILE_ROWS + threadIdx.y * MK_SKY_CHOICE_RAYS;
  float mn[2] = {3.0e38f, 3.0e38f}, mx[2] = {-3.0e38f, -3.0e38f};
#pragma unroll 4
  for (int r = 0; r < MK_SKY_CHOICE_RAYS; ++r) sky_ray_minmax(p, x, y0 + r, mn, mx);
  const TexChoice ch = sky_block_choice(sky_t, mn, mx, part, tid, NW);
  if (tid == 0) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    choices[2 * tile] = ch.mode;
    choices[2 * tile + 1] = ch.level;
  }
}


// K2 alone (T1): caller-given batches of n samples, one block per batch
// (coordinates in periods for the 3D texture, unit directions for the
// lat-long map), with the choice and lookups of the texture-mode frame.
// Replaces the harnesses around the TPU samplers (tests/test_texsample.py:40,
// :54; tools/tpu_checks.py:138; tools/measure_band_fidelity.py:181, each a
// pallas_call around ops/pallas/texsample.py's sample_tex3d or
// sample_latlong).  Plain version: ops/kernels/texsample.py::_tex3d_batches
// and _latlong_batches, through ops/kernels/megakernel.py::sample_batches.
//
// What bounds it on an H100: bytes, 16 a sample (three coordinates read,
// one value written) plus the pyramid; about 110 operations a sample take a
// third of that time.  Next come the lookups: 8 (3D) or 4 (lat-long)
// gathers a sample, whose lanes spread over many cache lines when a batch's
// positions are scattered.  What the design does about it:
//   * a batch's coordinates are read once: each thread wraps its samples
//     (or turns them into lat-long (u, v)), folds them into its min and max
//     and keeps them in dynamic shared memory, and the lookups read them
//     back from there after the choice (TS_KEEP samples at most: 96 KB for
//     the 3D texture).  A longer batch is read twice, once for the choice
//     and once for the lookups;
//   * after the choice, the texels a windowed or banded batch can touch (the
//     box of its min and max at the chosen level, which the choice's window
//     test already bounds) are copied into shared memory, at most TS_BOX,
//     and the lookups gather from there with the samplers' operations in
//     their order (tex3d_box_sample, latlong_box_sample); a floor-mode batch
//     or a larger box gathers from global memory (tex3d_sample,
//     latlong_sample);
//   * two blocks of TS_THREADS per SM (registers and shared memory sized for
//     it), so one block's loads run under the other's lookups, and a grid
//     of 1530 batches fills 5.8 waves of 264;
//   * rows whose planes start 16-byte aligned (VEC: n % 4 == 0 and every
//     plane's address) move 16 bytes a load and a store, each thread four
//     consecutive samples; any other row moves 4 bytes, a sample a thread;
//   * the choice is reduced by warp shuffles (warp_minmax): one barrier for
//     the warps' partials, one for the choice and box the first warp makes,
//     one after the box is copied.
// Every sample keeps the frame's operations, so values, modes and levels
// are those of the texture-mode frame and of the plain samplers.
#define TS_THREADS 512
#define TS_KEEP 8192
#define TS_BOX 4096

// W consecutive samples from index i of the coordinate planes, wrapped (3D)
// or turned into lat-long (u, v): f[axis][sample]
template <bool SHAPE, bool VEC>
__device__ __forceinline__ void ts_load(const float* __restrict__ a, const float* __restrict__ b,
                                        const float* __restrict__ c, size_t i,
                                        float (&f)[SHAPE ? 3 : 2][VEC ? 4 : 1]) {
  constexpr int W = VEC ? 4 : 1;
  float x[W], y[W], z[W];
  if constexpr (VEC) {
    const float4 va = __ldg(reinterpret_cast<const float4*>(a + i));
    const float4 vb = __ldg(reinterpret_cast<const float4*>(b + i));
    const float4 vc = __ldg(reinterpret_cast<const float4*>(c + i));
    x[0] = va.x, x[1] = va.y, x[2] = va.z, x[3] = va.w;
    y[0] = vb.x, y[1] = vb.y, y[2] = vb.z, y[3] = vb.w;
    z[0] = vc.x, z[1] = vc.y, z[2] = vc.z, z[3] = vc.w;
  } else {
    x[0] = __ldg(a + i);
    y[0] = __ldg(b + i);
    z[0] = __ldg(c + i);
  }
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if constexpr (SHAPE) {
      f[0][j] = wrap01(x[j]);
      f[1][j] = wrap01(y[j]);
      f[2][j] = wrap01(z[j]);
    } else {
      latlong_uv(x[j], y[j], z[j], f[0][j], f[1][j]);
    }
  }
}

// A batch's texel box at its chosen level: texels [lo, lo + dim) of each
// axis (x, y, z; lat-long: u, v and one plane), x fastest in shared memory.
struct TsBox {
  int lo[3];
  int dim[3];  // dim[0] == 0: no box (floor mode, or more than TS_BOX texels)
};

// The box of a windowed or banded batch: per axis the first and last texel
// index the choice's window test takes (tex3d_choose, latlong_choose) for
// the batch's min and max, which bound every tap of its samples.
template <bool SHAPE>
__device__ __forceinline__ TsBox ts_box(const TexParams& t, TexChoice ch, const float* mn,
                                        const float* mx) {
  TsBox box{{0, 0, 0}, {0, 1, 1}};
  if (ch.mode == MK_FLOOR) return box;
  int vol = 1;
  if constexpr (SHAPE) {
    const float S = (float)t.shape_size[ch.level];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      box.lo[ax] = (int)floorf(mn[ax] * S - 0.5f);
      box.dim[ax] = (int)floorf(mx[ax] * S - 0.5f) + 2 - box.lo[ax];
      vol *= box.dim[ax];
    }
  } else {
    const float Hl = (float)t.cov_height[ch.level], Wl = (float)t.cov_width[ch.level];
    box.lo[0] = (int)floorf(mn[0] * Wl - 0.5f);
    box.dim[0] = (int)floorf(mx[0] * Wl - 0.5f) + 2 - box.lo[0];
    box.lo[1] = (int)fmaxf(floorf(mn[1] * Hl - 0.5f), 0.0f);
    box.dim[1] = (int)fminf(floorf(mx[1] * Hl - 0.5f) + 1.0f, Hl - 1.0f) + 1 - box.lo[1];
    vol = box.dim[0] * box.dim[1];
  }
  if (vol > TS_BOX) box.dim[0] = 0;
  return box;
}

// tex3d_sample's windowed and banded lookups from the box: the same
// operations in the same order, the eight taps from shared memory
__device__ __forceinline__ float tex3d_box_sample(const TexParams& t, const float* box,
                                                  const TsBox& bx, TexChoice ch, float fx,
                                                  float fy, float fz) {
  const float Sf = (float)t.shape_size[ch.level];
  const float tx = fx * Sf - 0.5f, ty = fy * Sf - 0.5f, tz = fz * Sf - 0.5f;
  const float ix = floorf(tx), iy = floorf(ty), iz = floorf(tz);
  const float wx = tx - ix, wy = ty - iy, wz = tz - iz;
  const int nx = bx.dim[0], nxy = bx.dim[0] * bx.dim[1];
  const int l00 = ((int)iz - bx.lo[2]) * nxy + ((int)iy - bx.lo[1]) * nx + (int)ix - bx.lo[0];
  const int l01 = l00 + nx, l10 = l00 + nxy, l11 = l10 + nx;
  const float ax = 1.0f - wx, ay = 1.0f - wy, az = 1.0f - wz;
  const float c[8] = {box[l00], box[l00 + 1], box[l01], box[l01 + 1],
                      box[l10], box[l10 + 1], box[l11], box[l11 + 1]};
  const float w[8] = {__fmul_rn(__fmul_rn(az, ay), ax), __fmul_rn(__fmul_rn(az, ay), wx),
                      __fmul_rn(__fmul_rn(az, wy), ax), __fmul_rn(__fmul_rn(az, wy), wx),
                      __fmul_rn(__fmul_rn(wz, ay), ax), __fmul_rn(__fmul_rn(wz, ay), wx),
                      __fmul_rn(__fmul_rn(wz, wy), ax), __fmul_rn(__fmul_rn(wz, wy), wx)};
  float lo = __fmul_rn(c[0], w[0]);
#pragma unroll
  for (int k = 1; k < 4; ++k) lo = __fadd_rn(lo, __fmul_rn(c[k], w[k]));
  if (ch.mode == MK_BANDED) {  // the two z-slices' partial sums
    float hi = __fmul_rn(c[4], w[4]);
#pragma unroll
    for (int k = 5; k < 8; ++k) hi = __fadd_rn(hi, __fmul_rn(c[k], w[k]));
    return __fadd_rn(lo, hi);
  }
#pragma unroll
  for (int k = 4; k < 8; ++k) lo = __fadd_rn(lo, __fmul_rn(c[k], w[k]));
  return lo;
}

// latlong_sample's windowed lookup from the box: the same operations in the
// same order, the four taps from shared memory
__device__ __forceinline__ float latlong_box_sample(const TexParams& t, const float* box,
                                                    const TsBox& bx, TexChoice ch, float fu,
                                                    float v) {
  const int Hi = t.cov_height[ch.level];
  const float Hs = (float)Hi, Ws = (float)t.cov_width[ch.level];
  const float tu = fu * Ws - 0.5f;
  const float u0f = floorf(tu);
  const float wu = tu - u0f;
  const int u0 = (int)u0f - bx.lo[0];
  const float tv = v * Hs - 0.5f;
  const float v0f = fminf(fmaxf(floorf(tv), 0.0f), Hs - 1.0f);
  const float wv = fminf(fmaxf(tv - v0f, 0.0f), 1.0f);
  const int v0 = (int)v0f;
  const int v1 = min(v0 + 1, Hi - 1);
  const int r0 = (v0 - bx.lo[1]) * bx.dim[0] + u0, r1 = (v1 - bx.lo[1]) * bx.dim[0] + u0;
  const float au = 1.0f - wu, av = 1.0f - wv;
  float s = __fmul_rn(box[r0], __fmul_rn(av, au));
  s = __fadd_rn(s, __fmul_rn(box[r0 + 1], __fmul_rn(av, wu)));
  s = __fadd_rn(s, __fmul_rn(box[r1], __fmul_rn(wv, au)));
  return __fadd_rn(s, __fmul_rn(box[r1 + 1], __fmul_rn(wv, wu)));
}

// keep != 0 (n <= TS_KEEP): the coordinates stay in dynamic shared memory,
// N planes of n floats, and the box follows them; else only the box.
template <bool SHAPE, bool VEC>
__global__ void __launch_bounds__(TS_THREADS, 2)
    texsample_kernel(const TexParams t, const float* __restrict__ tab,
                     const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ c, int n, int keep, float* __restrict__ out,
                     int* __restrict__ choice) {
  constexpr int N = SHAPE ? 3 : 2;  // coordinates a sample keeps
  constexpr int W = VEC ? 4 : 1;    // consecutive samples a thread takes at once
  constexpr int NW = TS_THREADS / 32;
  extern __shared__ float4 ts_smem[];
  __shared__ float part[NW * 2 * N];
  __shared__ int pick[8];  // mode, level, the box's lo and dim
  float* kept = reinterpret_cast<float*>(ts_smem);
  float* box = kept + (keep ? N * n : 0);
  const size_t off = (size_t)blockIdx.x * n;
  const int groups = n / W;  // VEC: n % 4 == 0
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float mn[N], mx[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    mn[k] = 3.0e38f;
    mx[k] = -3.0e38f;
  }
  for (int q = threadIdx.x; q < groups; q += TS_THREADS) {
    float f[N][W];
    ts_load<SHAPE, VEC>(a, b, c, off + (size_t)q * W, f);
#pragma unroll
    for (int k = 0; k < N; ++k) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        mn[k] = fminf(mn[k], f[k][j]);
        mx[k] = fmaxf(mx[k], f[k][j]);
      }
      if (keep) {
        if constexpr (VEC)
          reinterpret_cast<float4*>(kept + k * n)[q] = make_float4(f[k][0], f[k][1], f[k][2], f[k][3]);
        else
          kept[k * n + q] = f[k][0];
      }
    }
  }
  warp_minmax<N>(mn, mx);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      part[warp * 2 * N + k] = mn[k];
      part[warp * 2 * N + N + k] = mx[k];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      mn[k] = lane < NW ? part[lane * 2 * N + k] : 3.0e38f;
      mx[k] = lane < NW ? part[lane * 2 * N + N + k] : -3.0e38f;
    }
    warp_minmax<N>(mn, mx);
    if (lane == 0) {
      const TexChoice ch = SHAPE ? tex3d_choose(t, mn, mx)
                                 : latlong_choose(t, mn[0], mx[0], mn[N - 1], mx[N - 1]);
      const TsBox bx = ts_box<SHAPE>(t, ch, mn, mx);
      pick[0] = ch.mode;
      pick[1] = ch.level;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        pick[2 + ax] = bx.lo[ax];
        pick[5 + ax] = bx.dim[ax];
      }
      choice[2 * blockIdx.x] = ch.mode;
      choice[2 * blockIdx.x + 1] = ch.level;
    }
  }
  __syncthreads();
  const TexChoice ch{pick[0], pick[1]};
  const TsBox bx{{pick[2], pick[3], pick[4]}, {pick[5], pick[6], pick[7]}};
  if (bx.dim[0]) {  // copy the box's texels, x fastest
    const int plane = SHAPE ? t.shape_size[ch.level] : t.cov_width[ch.level];
    const float* level = tab + (SHAPE ? t.shape_base[ch.level] : t.cov_base[ch.level]) * 128;
    const int vol = bx.dim[0] * bx.dim[1] * bx.dim[2];
    for (int i = threadIdx.x; i < vol; i += TS_THREADS) {
      const int x = i % bx.dim[0], r = i / bx.dim[0];
      const int y = r % bx.dim[1], z = r / bx.dim[1];
      box[i] = __ldg(level + ((bx.lo[2] + z) * plane + bx.lo[1] + y) * plane + bx.lo[0] + x);
    }
    __syncthreads();
  }
  for (int q = threadIdx.x; q < groups; q += TS_THREADS) {
    float f[N][W];
    if (keep) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if constexpr (VEC) {
          const float4 v = reinterpret_cast<const float4*>(kept + k * n)[q];
          f[k][0] = v.x, f[k][1] = v.y, f[k][2] = v.z, f[k][3] = v.w;
        } else {
          f[k][0] = kept[k * n + q];
        }
      }
    } else {
      ts_load<SHAPE, VEC>(a, b, c, off + (size_t)q * W, f);
    }
    float v[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if constexpr (SHAPE)
        v[j] = bx.dim[0] ? tex3d_box_sample(t, box, bx, ch, f[0][j], f[1][j], f[2][j])
                         : tex3d_sample(t, tab, ch, f[0][j], f[1][j], f[2][j]);
      else
        v[j] = bx.dim[0] ? latlong_box_sample(t, box, bx, ch, f[0][j], f[1][j])
                         : latlong_sample(t, tab, ch, f[0][j], f[1][j]);
    }
    if constexpr (VEC)
      reinterpret_cast<float4*>(out + off)[q] = make_float4(v[0], v[1], v[2], v[3]);
    else
      out[off + q] = v[0];
  }
}

// ---------------------------------------------------------------------------
// Launchers: plain C interface for ctypes.  Each returns cudaGetLastError()
// after the launch (0 on success), or -1 for a configuration the kernel is
// not built for.  color, alpha: the (H, W, 3) and (H, W) frame planes (a
// chained layer reads them too); depth: nullptr, or an (H, W) plane of
// linear depth (written by the opaque pass, read by a chained layer).
// sky, sky_r, sky_g, sky_b: the panorama sky's pyramid struct and channel
// tables when params->with_sky, else nullptr; sky_choices: the tiles'
// choices that sky_choice_launch wrote for the same params (the procedural
// instance).  work: nullptr, or MK_WORK_SLOTS zeroed counters.

static bool rows_ok(const MegakernelParams* p) {
  return p->row0 >= 0 && p->rows >= 1 && p->row0 + p->rows <= p->height;
}

// the sky needs the opaque pass, its tables and a lat-long pyramid struct
static bool sky_ok(const MegakernelParams* p, const TexParams* sky, const float* r,
                   const float* g, const float* b) {
  return !p->with_sky || (p->with_opaque && !p->with_background && sky && r && g && b &&
                          sky->cov_levels >= 1 && sky->cov_levels <= MK_MAX_LEVELS);
}

// the tiles of a launch's grid, (width / 128) x (rows / 32) rounded up
static dim3 tile_grid(const MegakernelParams* p) {
  return dim3((p->width + MK_TILE_COLS - 1) / MK_TILE_COLS,
              (p->rows + MK_TILE_ROWS - 1) / MK_TILE_ROWS, 1);
}

extern "C" int sky_choice_launch(const MegakernelParams* params, const TexParams* sky,
                                 int* choices, void* stream) {
  if (!rows_ok(params) || !sky || !choices || sky->cov_levels < 1 ||
      sky->cov_levels > MK_MAX_LEVELS)
    return -1;
  sky_choice_kernel<<<tile_grid(params), dim3(128, MK_SKY_CHOICE_THREADS_Y, 1), 0,
                      (cudaStream_t)stream>>>(*params, *sky, choices);
  return (int)cudaGetLastError();
}

// The procedural instance for params: its kernel (one per C =
// coverage_lod the launcher takes), its dynamic shared memory in bytes and
// whether its rows take one opaque pass: knot rows, then MK_GEN_MARCH_ROWS
// per coarse pixel, then, where the block can still hold them (MK_SMEM_ROWS
// rows in all), MK_GEN_CACHE_ROWS per row of the group.  kernel is nullptr
// for a config the instance does not take.
using GenKernel = void (*)(const MegakernelParams, const TexParams, const float*, const float*,
                           const float*, const float*, const int*, float*, float*, float*,
                           unsigned long long*, int);

struct GenLayout {
  GenKernel kernel;
  int smem;
  int row_cache;
};

static GenLayout gen_layout(const MegakernelParams* p) {
  const int C = p->coverage_lod, G = p->cloud_lod * C;
  GenLayout out{nullptr, 0, 0};
  if (p->cloud_lod < 1 || C < 1 || MK_TILE_ROWS % G || p->coverage_knots < 1 ||
      p->shape_knots < 1)
    return out;
  const int rows = knot_rows(*p) + MK_GEN_MARCH_ROWS * C;
  if (rows > MK_SMEM_ROWS) return out;
  out.row_cache = rows + MK_GEN_CACHE_ROWS * G <= MK_SMEM_ROWS;
  out.smem = (rows + (out.row_cache ? MK_GEN_CACHE_ROWS * G : 0)) * MK_TILE_COLS * (int)sizeof(float);
  const bool ext = scene_buffer(*p);
  switch (C) {
    case 1: out.kernel = ext ? megakernel_gen<1, true> : megakernel_gen<1, false>; break;
    case 2: out.kernel = ext ? megakernel_gen<2, true> : megakernel_gen<2, false>; break;
    case 4: out.kernel = ext ? megakernel_gen<4, true> : megakernel_gen<4, false>; break;
    case 8: out.kernel = ext ? megakernel_gen<8, true> : megakernel_gen<8, false>; break;
    case 16: out.kernel = ext ? megakernel_gen<16, true> : megakernel_gen<16, false>; break;
    case 32: out.kernel = ext ? megakernel_gen<32, true> : megakernel_gen<32, false>; break;
  }
  return out;
}

// the cloud-free instance for a launch's params (EXT where it reads the
// scene's buffer)
static auto clear_kernel(const MegakernelParams* p) {
  return scene_buffer(*p) ? megakernel_clear<true> : megakernel_clear<false>;
}

// dynamic shared memory above the default 48 KB needs the kernel's
// attribute raised first (never lowered: a smaller launch fits under it)
static cudaError_t gen_smem_attribute(const GenLayout& gen) {
  if (gen.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(gen.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, gen.smem);
}

extern "C" int megakernel_launch(const MegakernelParams* params, const TexParams* sky,
                                 const float* blue, const float* sky_r, const float* sky_g,
                                 const float* sky_b, const int* sky_choices, float* color,
                                 float* alpha, float* depth, void* stream, void* work) {
  const bool clouds = params->clouds_enabled && params->with_atmosphere;
  const GenLayout gen = clouds ? gen_layout(params) : GenLayout{nullptr, 0, 0};
  if (clouds && !gen.kernel) return -1;
  const int G = clouds ? params->cloud_lod * params->coverage_lod : 1;
  if (!rows_ok(params)) return -1;
  if ((params->with_background || !params->with_atmosphere) && !depth) return -1;
  if (!sky_ok(params, sky, sky_r, sky_g, sky_b) ||
      (params->with_sky && (MK_TILE_ROWS % G || !sky_choices)))
    return -1;
  // a partial last group enters its coarse inputs whole (its rows past the
  // launch are computed, not stored), as the TPU kernel pads its last
  // 32-row tile
  dim3 block(MK_TILE_COLS, 1, 1);
  dim3 grid((params->width + MK_TILE_COLS - 1) / MK_TILE_COLS, (params->rows + G - 1) / G, 1);
  const TexParams sky_t = sky ? *sky : TexParams{};
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* w = (unsigned long long*)work;
  if (!clouds) {
    clear_kernel(params)<<<grid, block, 0, s>>>(*params, sky_t, blue, sky_r, sky_g, sky_b,
                                                sky_choices, color, alpha, depth, w);
    return (int)cudaGetLastError();
  }
  const cudaError_t err = gen_smem_attribute(gen);
  if (err != cudaSuccess) return (int)err;
  gen.kernel<<<grid, block, gen.smem, s>>>(*params, sky_t, blue, sky_r, sky_g, sky_b, sky_choices,
                                           color, alpha, depth, w, gen.row_cache);
  return (int)cudaGetLastError();
}

// What the procedural instance for these params uses, as the launcher would
// launch it: out = {coarse pixels per thread, registers per thread, local
// memory (stack) bytes per thread, resident blocks per SM, dynamic shared
// memory bytes, 1 with the row cache (one opaque pass per pixel) else 0}.
extern "C" int megakernel_gen_info(const MegakernelParams* params, int* out) {
  const GenLayout gen = gen_layout(params);
  if (!gen.kernel) return -1;
  cudaFuncAttributes attr;
  cudaError_t err = gen_smem_attribute(gen);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, gen.kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gen.kernel, MK_TILE_COLS,
                                                        gen.smem);
  if (err != cudaSuccess) return (int)err;
  const int info[6] = {params->coverage_lod, attr.numRegs, (int)attr.localSizeBytes, blocks,
                       gen.smem, gen.row_cache};
  for (int i = 0; i < 6; ++i) out[i] = info[i];
  return 0;
}

// What the cloud-free instance uses, as the launcher launches it: out =
// {registers per thread, local memory (stack) bytes per thread, resident
// blocks per SM, threads per block, blocks of the launch for params}.
extern "C" int megakernel_clear_info(const MegakernelParams* params, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, clear_kernel(params));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, clear_kernel(params), MK_TILE_COLS,
                                                        0);
  if (err != cudaSuccess) return (int)err;
  const int info[5] = {attr.numRegs, (int)attr.localSizeBytes, blocks, MK_TILE_COLS,
                       (params->width + MK_TILE_COLS - 1) / MK_TILE_COLS * params->rows};
  for (int i = 0; i < 5; ++i) out[i] = info[i];
  return 0;
}

template <int G>
static int launch_tex(const MegakernelParams* p, const TexParams* t, const TexParams& sky,
                      const float* blue, const float* shape_tab, const float* cov_tab,
                      const float* sky_r, const float* sky_g, const float* sky_b, float* color,
                      float* alpha, float* depth, cudaStream_t stream,
                      unsigned long long* work) {
  constexpr int smem = tex_smem(G);
  auto kernel = scene_buffer(*p) ? megakernel_tex<MK_KNOTS, MK_SHAPE_KNOTS, G, true>
                                 : megakernel_tex<MK_KNOTS, MK_SHAPE_KNOTS, G, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  dim3 block(MK_TILE_COLS, MK_TILE_ROWS / G, 1);
  kernel<<<tile_grid(p), block, smem, stream>>>(*p, *t, sky, blue, shape_tab, cov_tab, sky_r, sky_g,
                                        sky_b, color, alpha, depth, work);
  return (int)cudaGetLastError();
}

// The texture instances (megakernel_tex_info's last entry, the launcher's
// report): the fixed megakernel_tex<K, KS, G> takes the demo's profile (both
// fields baked, K = 8, KS = 16, low quality, G = 4 or 8);
// megakernel_tex_general takes every other texture config, and any config
// the caller asks it for (general != 0)
constexpr int MK_TEX_FIXED = 0;
constexpr int MK_TEX_GENERAL = 1;

static int tex_instance(const MegakernelParams* p, const TexParams* t, int general) {
  const int G = p->cloud_lod * p->coverage_lod;
  const bool fixed = t->shape_source == MK_SRC_PYRAMID && t->cov_source == MK_SRC_PYRAMID &&
                     p->coverage_knots == MK_KNOTS && t->shape_knots == MK_SHAPE_KNOTS &&
                     p->always_low && (G == 4 || G == 8);
  return fixed && !general ? MK_TEX_FIXED : MK_TEX_GENERAL;
}

// a field's source against the launch: a pyramid needs its table, 1 to
// MK_MAX_LEVELS levels and knots (a baked field is sampled at knots only,
// as in the JAX kernel); knots or per step follow the config's knot flag
static bool source_ok(int src, int interp, const float* tab, int levels) {
  if (src == MK_SRC_PYRAMID) return interp && tab && levels >= 1 && levels <= MK_MAX_LEVELS;
  return (src == MK_SRC_KNOTS && interp) || (src == MK_SRC_STEP && !interp);
}

// The general instance's launch (ok = 0 for params it does not take): its
// frame's dynamic shared memory (the knot rows and MK_GEN_MARCH_ROWS per
// coarse pixel, as gen_layout's without its row cache), and its tile pass's
// thread rows and shared memory (the groups' knot inputs, the warps'
// partials of one chunk of slots).
struct TexgLayout {
  int ok, smem;
  int choice_rows, choice_smem;
};

static TexgLayout texg_layout(const MegakernelParams* p, const TexParams* t) {
  const int C = p->coverage_lod, G = p->cloud_lod * C;
  TexgLayout out{0, 0, 0, 0};
  if (p->cloud_lod < 1 || C < 1 || MK_TILE_ROWS % G || t->knot_group < 1 ||
      p->coverage_knots < 1 || p->shape_knots < 1)
    return out;
  const int rows = texg_knot_rows(*p, *t) + MK_GEN_MARCH_ROWS * C;
  if (rows > MK_SMEM_ROWS) return out;
  out.smem = rows * MK_TILE_COLS * (int)sizeof(float);
  const int ngr = MK_TILE_ROWS / G;
  out.choice_rows = min(MK_TEXG_CHOICE_ROWS, ngr);
  const int warps = out.choice_rows * MK_TILE_COLS / 32;
  out.choice_smem = (MK_TEXG_GROUP_FLOATS * ngr * MK_TILE_COLS +
                     min(texg_choice_slots(*p, *t), MK_TEXG_CHUNK) * warps * 6) *
                    (int)sizeof(float);
  out.ok = 1;
  return out;
}

// the general instance's tile pass and frame kernel for a launch's params
// (EXT where it reads the scene's buffer)
static auto texg_choice_kernel(const MegakernelParams* p) {
  return scene_buffer(*p) ? tex_choice_kernel<true> : tex_choice_kernel<false>;
}

static auto texg_frame_kernel(const MegakernelParams* p) {
  return scene_buffer(*p) ? megakernel_tex_general<true> : megakernel_tex_general<false>;
}

// dynamic shared memory above the default 48 KB needs each kernel's
// attribute raised first (never lowered below it)
static cudaError_t texg_smem_attribute(const MegakernelParams* p, const TexgLayout& lay) {
  cudaError_t err = cudaSuccess;
  if (lay.smem > 48 * 1024)
    err = cudaFuncSetAttribute(texg_frame_kernel(p), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               lay.smem);
  if (err == cudaSuccess && lay.choice_smem > 48 * 1024)
    err = cudaFuncSetAttribute(texg_choice_kernel(p), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               lay.choice_smem);
  return err;
}

// The scratch of a launch's two kernels in scratch (scratch_floats floats:
// at least texg_scratch_floats), or nullptrs
static TexgScratch texg_scratch(const MegakernelParams* p, float* scratch, int scratch_floats) {
  if (!scratch || scratch_floats < texg_scratch_floats(*p)) return TexgScratch{nullptr, nullptr, 0};
  return TexgScratch{scratch, scratch + (size_t)p->rows * p->width * 4, texg_coarse_rows(*p)};
}

// The general instance's two launches: its tile pass into color, depth,
// the scratch (scratch_floats floats: at least texg_scratch_floats) and
// choices (choice_ints ints: at least 2 per slot and tile of the launch's
// grid), then its frame.
static int launch_tex_general(const MegakernelParams* p, const TexParams* t, const TexParams& sky,
                              const float* blue, const float* shape_tab, const float* cov_tab,
                              const float* sky_r, const float* sky_g, const float* sky_b,
                              float* scratch, int scratch_floats, int* choices, int choice_ints,
                              float* color, float* alpha, float* depth, cudaStream_t stream,
                              unsigned long long* work) {
  const TexgLayout lay = texg_layout(p, t);
  const TexgScratch sc = texg_scratch(p, scratch, scratch_floats);
  const dim3 tiles = tile_grid(p);
  if (!lay.ok || !sc.atm || !choices ||
      choice_ints < (long)tiles.x * tiles.y * texg_choice_slots(*p, *t) * 2)
    return -1;
  cudaError_t err = texg_smem_attribute(p, lay);
  if (err != cudaSuccess) return (int)err;
  texg_choice_kernel(p)<<<tiles, dim3(MK_TILE_COLS, lay.choice_rows, 1), lay.choice_smem,
                          stream>>>(
      *p, *t, sky, blue, sky_r, sky_g, sky_b, color, depth, sc, choices, work);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int G = p->cloud_lod * p->coverage_lod;
  const dim3 grid((p->width + MK_TILE_COLS - 1) / MK_TILE_COLS, (p->rows + G - 1) / G, 1);
  texg_frame_kernel(p)<<<grid, dim3(MK_TILE_COLS, 1, 1), lay.smem, stream>>>(
      *p, *t, shape_tab, cov_tab, choices, sc, color, alpha, work);
  return (int)cudaGetLastError();
}

// The texture instance's launch: the fixed instance where it takes the
// params (tex_instance), else the general one, two launches: its tile pass
// into the scratch (scratch_floats floats, at least texg_scratch_floats)
// and choices (choice_ints ints, at least 2 per slot and tile), then its
// frame (the fixed instance reads neither); general != 0 asks for the
// general instance whatever the params (both instances on one config, to
// compare them).  *instance, where given, gets the instance launched
// (MK_TEX_FIXED or MK_TEX_GENERAL).
extern "C" int megakernel_tex_launch(const MegakernelParams* params, const TexParams* tex,
                                     const TexParams* sky, const float* blue,
                                     const float* shape_tab, const float* cov_tab,
                                     const float* sky_r, const float* sky_g, const float* sky_b,
                                     float* color, float* alpha, float* depth, void* stream,
                                     void* work, int general, int* instance, int* choices,
                                     int choice_ints, float* scratch, int scratch_floats) {
  if (!params->clouds_enabled || !params->with_atmosphere || tex->knot_group < 1 ||
      !source_ok(tex->shape_source, params->shape_interp, shape_tab, tex->shape_levels) ||
      !source_ok(tex->cov_source, params->coverage_interp, cov_tab, tex->cov_levels) ||
      (tex->shape_source != MK_SRC_PYRAMID && tex->cov_source != MK_SRC_PYRAMID) ||
      !rows_ok(params) || (params->with_background && !depth) ||
      !sky_ok(params, sky, sky_r, sky_g, sky_b))
    return -1;
  const int G = params->cloud_lod * params->coverage_lod;
  const int which = tex_instance(params, tex, general);
  const TexParams sky_t = sky ? *sky : TexParams{};
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* w = (unsigned long long*)work;
  if (instance) *instance = which;
  if (which == MK_TEX_GENERAL)
    return launch_tex_general(params, tex, sky_t, blue, shape_tab, cov_tab, sky_r, sky_g, sky_b,
                              scratch, scratch_floats, choices, choice_ints, color, alpha, depth,
                              s, w);
  if (G == 4)
    return launch_tex<4>(params, tex, sky_t, blue, shape_tab, cov_tab, sky_r, sky_g, sky_b, color,
                         alpha, depth, s, w);
  if (G == 8)
    return launch_tex<8>(params, tex, sky_t, blue, shape_tab, cov_tab, sky_r, sky_g, sky_b, color,
                         alpha, depth, s, w);
  return -1;
}

// What the texture instance for these params uses, as the launcher would
// launch it (general as megakernel_tex_launch takes it): out = {rows per
// thread G, registers per thread, local memory (stack) bytes per thread,
// resident blocks per SM, dynamic shared memory bytes, threads per block,
// 1 for the general instance (0 for the fixed one); the general instance's
// tile pass's threads per block, dynamic shared memory bytes, registers per
// thread and resident blocks per SM (zeros for the fixed instance)}.  It
// sets the shared-memory attributes the launcher sets.
extern "C" int megakernel_tex_info(const MegakernelParams* params, const TexParams* tex,
                                   int* out, int general) {
  const int G = params->cloud_lod * params->coverage_lod;
  cudaFuncAttributes attr, choice_attr;
  int blocks = 0, choice_blocks = 0;
  if (tex_instance(params, tex, general) == MK_TEX_GENERAL) {
    const TexgLayout lay = texg_layout(params, tex);
    if (!lay.ok) return -1;
    const int choice_threads = MK_TILE_COLS * lay.choice_rows;
    cudaError_t err = texg_smem_attribute(params, lay);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, texg_frame_kernel(params));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, texg_frame_kernel(params),
                                                          MK_TILE_COLS, lay.smem);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&choice_attr, texg_choice_kernel(params));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&choice_blocks, texg_choice_kernel(params),
                                                          choice_threads, lay.choice_smem);
    if (err != cudaSuccess) return (int)err;
    const int info[11] = {G, attr.numRegs, (int)attr.localSizeBytes, blocks, lay.smem,
                          MK_TILE_COLS, 1, choice_threads, lay.choice_smem, choice_attr.numRegs,
                          choice_blocks};
    for (int i = 0; i < 11; ++i) out[i] = info[i];
    return 0;
  }
  const int nt = tex_threads(G), smem = tex_smem(G);
  const bool ext = scene_buffer(*params);
  auto kernel = G == 4 ? (ext ? megakernel_tex<MK_KNOTS, MK_SHAPE_KNOTS, 4, true>
                              : megakernel_tex<MK_KNOTS, MK_SHAPE_KNOTS, 4, false>)
                       : (ext ? megakernel_tex<MK_KNOTS, MK_SHAPE_KNOTS, 8, true>
                              : megakernel_tex<MK_KNOTS, MK_SHAPE_KNOTS, 8, false>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, nt, smem);
  if (err != cudaSuccess) return (int)err;
  const int info[11] = {G, attr.numRegs, (int)attr.localSizeBytes, blocks, smem, nt, 0, 0, 0, 0, 0};
  for (int i = 0; i < 11; ++i) out[i] = info[i];
  return 0;
}

template <bool SHAPE, bool VEC>
static int launch_texsample(const TexParams& t, const float* table, const float* a,
                            const float* b, const float* c, int n_batches, int n, float* out,
                            int* choice, cudaStream_t s) {
  constexpr int N = SHAPE ? 3 : 2;
  const int keep = n <= TS_KEEP;
  const int smem = ((keep ? N * n : 0) + TS_BOX) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(texsample_kernel<SHAPE, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (N * TS_KEEP + TS_BOX) * (int)sizeof(float));
  if (err == cudaSuccess)  // the SM's whole shared memory, for two blocks
    err = cudaFuncSetAttribute(texsample_kernel<SHAPE, VEC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  texsample_kernel<SHAPE, VEC><<<n_batches, TS_THREADS, smem, s>>>(t, table, a, b, c, n, keep,
                                                                  out, choice);
  return (int)cudaGetLastError();
}

// vector: 16-byte loads and stores (n % 4 == 0, and a, b, c and out 16-byte
// aligned, else -1).
extern "C" int texsample_launch(const TexParams* tex, int shape, const float* table,
                                const float* a, const float* b, const float* c,
                                int n_batches, int batch_size, int vector, float* out,
                                int* choice, void* stream) {
  if (n_batches < 1 || batch_size < 1) return -1;
  if (vector && (batch_size % 4 ||
                 ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)out) % 16))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (shape)
    return vector ? launch_texsample<true, true>(*tex, table, a, b, c, n_batches, batch_size, out, choice, s)
                  : launch_texsample<true, false>(*tex, table, a, b, c, n_batches, batch_size, out, choice, s);
  return vector ? launch_texsample<false, true>(*tex, table, a, b, c, n_batches, batch_size, out, choice, s)
                : launch_texsample<false, false>(*tex, table, a, b, c, n_batches, batch_size, out, choice, s);
}

// the work counter slots the instances write (MK_WORK_SLOTS), so the wrapper
// can check its WORK_SLOTS
extern "C" int megakernel_work_slots(void) { return MK_WORK_SLOTS; }

// sizeof the launch structs, so the wrapper can check its ctypes mirror
extern "C" int megakernel_params_size(void) { return (int)sizeof(MegakernelParams); }
extern "C" int megakernel_noise_params_size(void) { return (int)sizeof(NoiseParams); }
extern "C" int megakernel_tex_params_size(void) { return (int)sizeof(TexParams); }
