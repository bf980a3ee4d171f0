// TAA resolve (K3) for NVIDIA Hopper (sm_90a): blend the current frame with
// the previous resolved frame reprojected through the camera motion.
//
// Replaces the TPU Pallas kernel
//   godot_atmosphere_shader_tpu/ops/pallas/taa.py::taa_resolve (pallas_call
//   at taa.py:345; kernel body _taa_kernel, :57)
// with its band mode (row sharding: the current planes hold a shard's rows
// from global row row0, the history planes its history band from global row
// hist_row0; a whole frame is row0 = hist_row0 = 0).  Its plain PyTorch
// version is
//   godot_atmosphere_shader_tpu_torch/ops/kernels/taa.py::resolve_plain,
// and every formula below follows that code's operation order with
// uncontracted arithmetic (__fmul_rn, __fadd_rn, ...) and correctly
// rounded division and square root, so the two agree bit for bit on the same
// inputs.
//
// What it computes, per pixel of a 32 x 128 tile: the world position at the
// current linear depth (pad rows of a partial last tile, past the band's own
// rows, take depth 1.0, as on the TPU), its projection into the previous
// camera at the pixel's global row, validity (in front of the camera, inside
// the frame, inside the tile's history window in the history band's rows, and
// the bilinear history depth within depth_eps of the current depth), the
// bilinear history colour, a 3 x 3 tile-local neighbourhood clamp (min/max
// box or mean +- gamma sigma; taps across the tile edge or on pad rows take
// the centre value), and the blend.
//
// The window rule.  The TPU kernel copies a 64 x 384 history window per
// tile (rows aligned to 8, columns to 128) and marks reprojections outside
// it invalid (taa.py:137-162).  Hopper gathers directly, so there is no
// window here, but its base (a tile-wide min of the reprojected
// coordinates) and its validity rule are kept exactly: they decide the
// result.
//
// What bounds it on an H100.  About 48 B per pixel must move (current rgb
// and depth read, the history's rgb and depth read once, rgb and depth
// written): 100 MB at 1080p, 0.030 ms at 3.35 TB/s, its roofline bound.  In
// practice instruction issue bounds it with the bytes (cutting the clamp's
// instructions alone, at the same bytes, made it 11 % faster): the
// reprojection's five correctly rounded divisions and one square root, the
// 16 history gathers and the 3 x 3 clamp of three channels.  Within a tile
// the work is serial: the reprojection, the window
// base (a tile-wide min), the history gathers at addresses that depend on
// it, the clamp.  A design with one 1024-thread block per tile (64
// registers: one tile per SM) left the SM without loads in flight between
// its phases, read and wrote the 12-byte rgb pixels one channel at a time,
// and tested each clamp tap's bounds once per channel; 0.076 ms at 1080p.
// What the design does about it:
//   * a tile is a thread-block cluster of TAA_CTAS = 2 CTAs of 128 x 4
//     threads, each CTA 16 of the tile's rows and each thread every fourth
//     row of one column of them; the window base is the cluster's min
//     through distributed shared memory; registers are capped for
//     TAA_MIN_BLOCKS = 3 resident CTAs per SM (40), so CTAs of several
//     tiles share an SM and one tile's gathers overlap another's
//     reprojection or clamp;
//   * the CTA's current rgb (and the tile's rows just above and below it,
//     for the clamp) is copied into shared memory by 16-byte asynchronous
//     copies issued first, in flight while the reprojection runs; the clamp
//     reads all three channels from it after one barrier;
//   * each clamp tap's shared-memory offset is computed once per pixel for
//     the three channels (a tap outside the tile reads the centre, the
//     value the rule gives it), and plane offsets are 32-bit;
//   * the output rgb is written through shared memory as 16-byte stores;
//   * history read with __ldg (a tile's footprint is a few rows around its
//     own, L2-resident); depth and validity one coalesced word or byte per
//     pixel.
// On an H100 at 700 W: 0.0556 ms at 1080p (device time), 53 % of the bound,
// and 0.0160 ms on a 256-row shard of 1920 x 1024, against 0.0758 and 0.0180
// before, bit for bit the same frame, depth and validity (PERF.md;
// compare_megakernel.py).  Clusters of 4 CTAs, one 512-thread or 1024-thread
// CTA per tile and 2 or 4 CTAs per SM were measured and are slower on the
// shard or at 1080p (in git history at 394a1ac).
//
// Built with the other kernels (ops/kernels/library.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -fmad=true -c -o taa.o taa.cu

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TAA_TILE_ROWS 32
#define TAA_TILE_COLS 128
// CTAs per tile (a thread-block cluster), threads per column of a CTA, and
// the resident CTAs per SM its registers are sized for
#define TAA_CTAS 2
#define TAA_THREADS_Y 4
#define TAA_MIN_BLOCKS 3
constexpr int TAA_THREADS = TAA_TILE_COLS * TAA_THREADS_Y;
constexpr int TAA_WARPS = TAA_THREADS / 32;
constexpr int TAA_CTA_ROWS = TAA_TILE_ROWS / TAA_CTAS;
constexpr int TAA_ROWS_PER_THREAD = TAA_CTA_ROWS / TAA_THREADS_Y;
constexpr int TAA_ROW_FLOATS = TAA_TILE_COLS * 3;  // one row of a tile's rgb
static_assert(TAA_TILE_ROWS % TAA_CTAS == 0 && TAA_CTA_ROWS % TAA_THREADS_Y == 0,
              "a CTA is whole rows of the tile, a thread whole rows of the CTA");
// Dynamic shared memory of a CTA: its current rgb with one row above and one
// below, its output rgb, and the min's scratch (2 floats per warp and the
// CTA's 2).
constexpr int taa_smem_bytes() {
  return ((TAA_CTA_ROWS + 2) * TAA_ROW_FLOATS + TAA_CTA_ROWS * TAA_ROW_FLOATS +
          2 * TAA_WARPS + 2) * (int)sizeof(float);
}

// Launch parameters; mirrored field for field by ctypes
// (ops/kernels/taa.py: TaaParams, checked by a test that parses this file).
struct TaaParams {
  int height;           // rows of the whole frame (the projection's)
  int width;
  int rows;             // rows of the current planes: the band's, or height
  int row0;             // global row of the current planes' first row
  int hist_rows;        // rows of the history planes
  int hist_row0;        // global row of the history planes' first row
  int win_rows;         // the TPU window: min(64, hist_rows // 8 * 8)
  int win_cols;         // min(384, width // 128 * 128)
  int variance;         // clamp: 0 the 3 x 3 min/max box, 1 mean +- gamma sigma
  float w2v_prev[16];   // previous camera's world -> view, row-major
  float rot[9];         // current camera's view -> world rotation, row-major
  float pos[3];         // current camera's position
  float sx_cur;         // f32(aspect) * tan(fov / 2) of the current camera
  float sy_cur;         // tan(fov / 2)
  float sx_prev;        // the same for the previous camera
  float sy_prev;
  float blend;          // weight of the current frame where history is valid
  float depth_eps;
  float clamp_gamma;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// row-major 3 x 4 affine row times (x, y, z, 1), in the plain version's order
__device__ __forceinline__ float affine_row(const float* m, float x, float y, float z) {
  return add(add(add(mul(m[0], x), mul(m[1], y)), mul(m[2], z)), m[3]);
}

__device__ __forceinline__ float lerp_rows(float v0, float v1, float w) {
  return add(mul(v0, sub(1.0f, w)), mul(v1, w));
}

// a 16-byte asynchronous copy from global to shared memory (cp.async)
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The tile-wide min of two values per thread; every thread receives both.
// red: 2 floats per warp and 2 for the CTA's min.  Waits for the thread's
// asynchronous copies before the CTA's barrier, so shared memory holds them
// after it.  Each thread reads every CTA's min through distributed shared
// memory between two halves of a cluster barrier; the arrive after the
// reads lets a peer exit (tile_exit waits for it).
__device__ __forceinline__ void tile_min2(float& a, float& b, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    a = fminf(a, __shfl_xor_sync(0xffffffffu, a, off));
    b = fminf(b, __shfl_xor_sync(0xffffffffu, b, off));
  }
  const int tid = threadIdx.y * TAA_TILE_COLS + threadIdx.x;
  if ((tid & 31) == 0) {
    red[2 * (tid >> 5)] = a;
    red[2 * (tid >> 5) + 1] = b;
  }
  copies_done();
  __syncthreads();
  if (tid < 32) {
    a = tid < TAA_WARPS ? red[2 * tid] : 3.0e38f;
    b = tid < TAA_WARPS ? red[2 * tid + 1] : 3.0e38f;
    for (int off = 16; off > 0; off >>= 1) {
      a = fminf(a, __shfl_xor_sync(0xffffffffu, a, off));
      b = fminf(b, __shfl_xor_sync(0xffffffffu, b, off));
    }
    if (tid == 0) {
      red[2 * TAA_WARPS] = a;
      red[2 * TAA_WARPS + 1] = b;
    }
  }
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  a = b = 3.0e38f;
#pragma unroll
  for (int c = 0; c < TAA_CTAS; ++c) {
    const float* rr = cluster.map_shared_rank(red + 2 * TAA_WARPS, c);
    a = fminf(a, rr[0]);
    b = fminf(b, rr[1]);
  }
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

// before exit: every peer of the cluster has read this CTA's min
__device__ __forceinline__ void tile_exit() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__global__ void __launch_bounds__(TAA_THREADS, TAA_MIN_BLOCKS)
    taa_kernel(const TaaParams p, const float* __restrict__ cur,
               const float* __restrict__ linear_depth, const float* __restrict__ hist,
               const float* __restrict__ hist_depth, float* __restrict__ out,
               float* __restrict__ depth_out, uint8_t* __restrict__ valid_out) {
  extern __shared__ __align__(16) float smem[];
  // row lr + 1 holds the CTA's row lr, rows 0 and TAA_CTA_ROWS + 1 the
  // tile's rows just above and below it
  float* plane = smem;
  float* out_s = smem + (TAA_CTA_ROWS + 2) * TAA_ROW_FLOATS;
  float* red = out_s + TAA_CTA_ROWS * TAA_ROW_FLOATS;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TAA_TILE_COLS + tx;
  const int rank = blockIdx.y % TAA_CTAS;  // the CTA's band of the tile
  const int tile_y = blockIdx.y / TAA_CTAS * TAA_TILE_ROWS;
  const int cta_y = tile_y + rank * TAA_CTA_ROWS;  // the band's row of the CTA's first row
  const int x0 = blockIdx.x * TAA_TILE_COLS;
  const int x = x0 + tx;
  const float W = (float)p.width, H = (float)p.height;
  const float xf = (float)x;
  const float hist_r0 = (float)p.hist_row0;

  // ---- the current rgb of the CTA's rows and of the tile's rows next to
  // them into shared memory, in flight during the reprojection; pad rows
  // (past the band's own rows) are zeros ----
  {
    constexpr int V = TAA_ROW_FLOATS / 4;
    const int first = rank > 0 ? -1 : 0;
    const int last = TAA_CTA_ROWS + (rank < TAA_CTAS - 1 ? 1 : 0);
    for (int i = tid; i < (last - first) * V; i += TAA_THREADS) {
      const int lr = first + i / V, v = i % V;
      const int y = cta_y + lr;
      float* dst = plane + (lr + 1) * TAA_ROW_FLOATS + 4 * v;
      if (y < p.rows)
        copy16(dst, cur + ((size_t)y * p.width + x0) * 3 + 4 * v);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  // ---- reprojection of this thread's pixels into the previous camera ----
  const float ndc_x = sub(dvd(mul(2.0f, add(xf, 0.5f)), W), 1.0f);
  const float dvx = mul(ndc_x, p.sx_cur);
  float ld[TAA_ROWS_PER_THREAD], py[TAA_ROWS_PER_THREAD], px[TAA_ROWS_PER_THREAD];
  bool valid[TAA_ROWS_PER_THREAD];
  float base_y = 3.0e38f, base_x = 3.0e38f;
#pragma unroll
  for (int k = 0; k < TAA_ROWS_PER_THREAD; ++k) {
    const int y = cta_y + ty + TAA_THREADS_Y * k;  // the band's row
    const bool in_frame = y < p.rows;               // the band's own extent
    const int o = y * p.width + x;
    const float yf = (float)(y + p.row0);           // the global row
    const float ndc_y = sub(1.0f, dvd(mul(2.0f, add(yf, 0.5f)), H));
    const float dvy = mul(ndc_y, p.sy_cur);
    const float inv = dvd(1.0f, __fsqrt_rn(add(add(mul(dvx, dvx), mul(dvy, dvy)), 1.0f)));
    const float dx = mul(dvx, inv), dy = mul(dvy, inv), dz = mul(-1.0f, inv);
    const float dirx = add(add(mul(p.rot[0], dx), mul(p.rot[1], dy)), mul(p.rot[2], dz));
    const float diry = add(add(mul(p.rot[3], dx), mul(p.rot[4], dy)), mul(p.rot[5], dz));
    const float dirz = add(add(mul(p.rot[6], dx), mul(p.rot[7], dy)), mul(p.rot[8], dz));
    // pad rows of a partial last tile take depth 1.0 (they join the window
    // base, as on the TPU); sky's 1e7 keeps the multiply-adds finite
    const float d = fminf(in_frame ? linear_depth[o] : 1.0f, 1.0e7f);
    ld[k] = d;
    const float wx = add(p.pos[0], mul(dirx, d));
    const float wy = add(p.pos[1], mul(diry, d));
    const float wz = add(p.pos[2], mul(dirz, d));
    const float vx = affine_row(p.w2v_prev, wx, wy, wz);
    const float vy = affine_row(p.w2v_prev + 4, wx, wy, wz);
    const float vz = affine_row(p.w2v_prev + 8, wx, wy, wz);
    const float neg_z = fmaxf(-vz, 1e-6f);
    const float pndc_x = dvd(dvd(vx, neg_z), p.sx_prev);
    const float pndc_y = dvd(dvd(vy, neg_z), p.sy_prev);
    px[k] = sub(mul(mul(add(pndc_x, 1.0f), 0.5f), W), 0.5f);
    py[k] = sub(mul(mul(sub(1.0f, pndc_y), 0.5f), H), 0.5f);
    valid[k] = vz < -1e-3f && px[k] >= 0.0f && px[k] <= W - 1.0f && py[k] >= 0.0f &&
               py[k] <= H - 1.0f;
    // the window base, in the history band's rows, sees valid
    // reprojections; the rest their own pixel
    py[k] = sub(py[k], hist_r0);
    base_y = fminf(base_y, valid[k] ? py[k] : sub(yf, hist_r0));
    base_x = fminf(base_x, valid[k] ? px[k] : xf);
  }

  // ---- the TPU's history window: base and validity rule ----
  tile_min2(base_y, base_x, red);
  int ry0 = min(max((int)floorf(base_y) - 2, 0), p.hist_rows - p.win_rows);
  ry0 = (ry0 >> 3) << 3;
  int rx0 = min(max((int)floorf(base_x) - 8, 0), p.width - p.win_cols);
  rx0 = (rx0 >> 7) << 7;
  const float rmax = (float)((double)p.win_rows - 1.001);
  const float cmax = (float)((double)p.win_cols - 1.001);

  // ---- per pixel: bilinear history (direct gathers), depth validity, the
  // 3 x 3 tile-local clamp of each channel, the blend ----
  const float ninth = (float)(1.0 / 9.0);
#pragma unroll
  for (int k = 0; k < TAA_ROWS_PER_THREAD; ++k) {
    float ryf = sub(py[k], (float)ry0);
    float rxf = sub(px[k], (float)rx0);
    bool v = valid[k] && ryf >= 0.0f && ryf <= rmax && rxf >= 0.0f && rxf <= cmax;
    ryf = fminf(fmaxf(ryf, 0.0f), rmax);
    rxf = fminf(fmaxf(rxf, 0.0f), cmax);
    const float r0f = floorf(ryf), c0f = floorf(rxf);
    const float wy = sub(ryf, r0f), wx = sub(rxf, c0f);
    const int o0 = (ry0 + (int)r0f) * p.width + rx0 + (int)c0f;
    const int o1 = o0 + p.width;
    float h[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float h0 = lerp_rows(__ldg(hist + o0 * 3 + ch), __ldg(hist + (o0 + 1) * 3 + ch), wx);
      const float h1 = lerp_rows(__ldg(hist + o1 * 3 + ch), __ldg(hist + (o1 + 1) * 3 + ch), wx);
      h[ch] = lerp_rows(h0, h1, wy);
    }
    const float d0 = lerp_rows(fminf(__ldg(hist_depth + o0), 1.0e7f),
                               fminf(__ldg(hist_depth + o0 + 1), 1.0e7f), wx);
    const float d1 = lerp_rows(fminf(__ldg(hist_depth + o1), 1.0e7f),
                               fminf(__ldg(hist_depth + o1 + 1), 1.0e7f), wx);
    const float hist_ld = lerp_rows(d0, d1, wy);
    v = v && fabsf(sub(hist_ld, ld[k])) <= mul(p.depth_eps, fmaxf(ld[k], 1e-3f));
    const float a_cur = v ? p.blend : 1.0f;

    const int lr = ty + TAA_THREADS_Y * k;   // the CTA's row
    const int tr = rank * TAA_CTA_ROWS + lr;  // the tile's row
    const int y = cta_y + lr;
    // The taps' shared-memory offsets, once for the three channels, in the
    // TPU's roll order: rows y+1, y, y-1; columns x+1, x, x-1.  A tap across
    // the tile edge or on a pad row takes the centre value, so it reads the
    // centre.  (A pad row's own value is not stored: its taps may be any.)
    const int centre_at = (lr + 1) * TAA_ROW_FLOATS + tx * 3;
    const bool row_ok[3] = {tr < TAA_TILE_ROWS - 1 && y + 1 < p.rows, true, tr > 0};
    const bool col_ok[3] = {tx < TAA_TILE_COLS - 1, true, tx > 0};
    int tap_at[8];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        if (a == 1 && b == 1) continue;
        tap_at[3 * a + b - (3 * a + b > 4)] =
            row_ok[a] && col_ok[b] ? centre_at + (1 - a) * TAA_ROW_FLOATS + (1 - b) * 3
                                   : centre_at;
      }
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float centre = plane[centre_at + ch];
      float lo = centre, hi = centre;
      if (p.variance) {
        float m1 = centre, m2 = mul(centre, centre);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float n = plane[tap_at[t] + ch];
          m1 = add(m1, n);
          m2 = add(m2, mul(n, n));
        }
        const float mu = mul(m1, ninth);
        const float sigma = __fsqrt_rn(fmaxf(sub(mul(m2, ninth), mul(mu, mu)), 0.0f));
        lo = sub(mu, mul(p.clamp_gamma, sigma));
        hi = add(mu, mul(p.clamp_gamma, sigma));
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float n = plane[tap_at[t] + ch];
          lo = fminf(lo, n);
          hi = fmaxf(hi, n);
        }
      }
      const float hc = fminf(fmaxf(h[ch], lo), hi);
      out_s[lr * TAA_ROW_FLOATS + tx * 3 + ch] = add(mul(centre, a_cur), mul(hc, sub(1.0f, a_cur)));
    }
    if (y < p.rows) {
      const int o = y * p.width + x;
      depth_out[o] = ld[k];  // min(linear depth, 1e7): the next frame's history depth
      if (valid_out) valid_out[o] = v;
    }
  }

  // ---- the output rgb of the CTA's rows, 16 bytes a store ----
  __syncthreads();
  constexpr int V = TAA_ROW_FLOATS / 4;
  for (int i = tid; i < TAA_CTA_ROWS * V; i += TAA_THREADS) {
    const int lr = i / V, v = i % V;
    const int y = cta_y + lr;
    if (y < p.rows)
      *reinterpret_cast<float4*>(out + ((size_t)y * p.width + x0) * 3 + 4 * v) =
          *reinterpret_cast<const float4*>(out_s + lr * TAA_ROW_FLOATS + 4 * v);
  }
  tile_exit();
}

// The launch configuration: TAA_CTAS CTAs of a tile as one cluster.
struct TaaLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  TaaLaunch(dim3 grid, cudaStream_t stream) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(TAA_TILE_COLS, TAA_THREADS_Y, 1);
    cfg.dynamicSmemBytes = (size_t)taa_smem_bytes();
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = TAA_CTAS;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// the kernel's dynamic shared memory above the default 48 KB needs its
// attribute raised first (one constant: never lowered)
static cudaError_t taa_smem_attribute() {
  if (taa_smem_bytes() <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(taa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              taa_smem_bytes());
}

// Launcher: plain C interface for ctypes.  Returns the CUDA error of the
// launch (0 on success), or -1 for shapes the kernel does not take.
// cur, linear_depth, out, depth_out (and valid): planes of the struct's rows;
// history, history_depth: planes of its hist_rows.  history_depth may be
// linear_depth itself (no history depth yet); valid: nullptr, or a byte
// plane that takes each pixel's validity.  cur and out move 16 bytes at a
// time: both must be 16-byte aligned.  Offsets into a plane are 32-bit.
extern "C" int taa_launch(const TaaParams* params, const float* cur, const float* linear_depth,
                          const float* history, const float* history_depth, float* out,
                          float* depth_out, unsigned char* valid, void* stream) {
  const TaaParams& p = *params;
  if (p.height < 1 || p.rows < 8 || p.rows % 8 || p.width < 128 || p.width % 128 ||
      p.hist_rows < 8 || p.hist_rows % 8 || p.win_rows < 8 || p.win_rows > p.hist_rows ||
      p.win_cols < 128 || p.win_cols > p.width || (((uintptr_t)cur | (uintptr_t)out) & 15) ||
      (long long)(p.rows > p.hist_rows ? p.rows : p.hist_rows) * p.width * 3 > 0x7fffffffLL)
    return -1;
  cudaError_t err = taa_smem_attribute();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.width / TAA_TILE_COLS,
                  (p.rows + TAA_TILE_ROWS - 1) / TAA_TILE_ROWS * TAA_CTAS, 1);
  TaaLaunch launch(grid, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&launch.cfg, taa_kernel, p, cur, linear_depth, history, history_depth,
                           out, depth_out, (uint8_t*)valid);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// What the kernel uses on this card: out = {CTAs per tile (per cluster),
// threads per CTA, registers per thread, local memory (stack) bytes per
// thread, resident CTAs per SM, dynamic shared memory bytes per CTA,
// resident clusters on the card}.
extern "C" int taa_info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = taa_smem_attribute();
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, taa_kernel);
  int blocks = 0, clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, taa_kernel, TAA_THREADS,
                                                        taa_smem_bytes());
  TaaLaunch launch(dim3(1, TAA_CTAS, 1), nullptr);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, taa_kernel, &launch.cfg);
  if (err != cudaSuccess) return (int)err;
  const int info[7] = {TAA_CTAS, TAA_THREADS, attr.numRegs, (int)attr.localSizeBytes, blocks,
                       taa_smem_bytes(), clusters};
  for (int i = 0; i < 7; ++i) out[i] = info[i];
  return 0;
}

// sizeof the launch struct, so the wrapper can check its ctypes mirror
extern "C" int taa_params_size(void) { return (int)sizeof(TaaParams); }
