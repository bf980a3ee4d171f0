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
// window here, but its base (a block-wide min of the reprojected
// coordinates) and its validity rule are kept exactly: they decide the
// result.
//
// What bounds it on an H100: bytes.  About 48 B per pixel must move (current
// rgb and depth read, the history's rgb and depth read once, rgb and depth
// written): 100 MB at 1080p, 0.03 ms at 3.35 TB/s.  The ~300 operations per
// pixel are far below the fp32 peak.  What the design does about it: one
// block of 128 x 8 threads per tile, each thread four rows of one column,
// rows interleaved so that a warp reads 32 consecutive pixels of one row;
// history read with __ldg (a tile's footprint is a few rows around its own,
// L2-resident); the tile's current colour goes through a 16 KB shared plane
// once per channel for the clamp; nothing else leaves registers.
//
// Built with the other kernels (ops/kernels/library.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -fmad=true -c -o taa.o taa.cu

#include <cuda_runtime.h>
#include <stdint.h>

#define TAA_TILE_ROWS 32
#define TAA_TILE_COLS 128
#define TAA_ROWS_PER_THREAD 4  // block (128, 8)

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

// Block-wide min of two values per thread; every thread receives both.
// red: 2 floats per warp of shared scratch.
__device__ __forceinline__ void block_min2(float& a, float& b, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    a = fminf(a, __shfl_xor_sync(0xffffffffu, a, off));
    b = fminf(b, __shfl_xor_sync(0xffffffffu, b, off));
  }
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if ((tid & 31) == 0) {
    red[2 * (tid >> 5)] = a;
    red[2 * (tid >> 5) + 1] = b;
  }
  __syncthreads();
  a = red[0];
  b = red[1];
  const int nwarps = (blockDim.x * blockDim.y) >> 5;
  for (int w = 1; w < nwarps; ++w) {
    a = fminf(a, red[2 * w]);
    b = fminf(b, red[2 * w + 1]);
  }
}

__global__ void __launch_bounds__(TAA_TILE_COLS * (TAA_TILE_ROWS / TAA_ROWS_PER_THREAD))
    taa_kernel(const TaaParams p, const float* __restrict__ cur,
               const float* __restrict__ linear_depth, const float* __restrict__ hist,
               const float* __restrict__ hist_depth, float* __restrict__ out,
               float* __restrict__ depth_out, uint8_t* __restrict__ valid_out) {
  __shared__ float plane[TAA_TILE_ROWS][TAA_TILE_COLS];
  __shared__ float red[2 * 32];
  const int tx = threadIdx.x;
  const int x = blockIdx.x * TAA_TILE_COLS + tx;
  const int tile_y = blockIdx.y * TAA_TILE_ROWS;
  const float W = (float)p.width, H = (float)p.height;
  const float xf = (float)x;
  const float hist_r0 = (float)p.hist_row0;

  // ---- reprojection of this thread's pixels into the previous camera ----
  const float ndc_x = sub(dvd(mul(2.0f, add(xf, 0.5f)), W), 1.0f);
  const float dvx = mul(ndc_x, p.sx_cur);
  float ld[TAA_ROWS_PER_THREAD], py[TAA_ROWS_PER_THREAD], px[TAA_ROWS_PER_THREAD];
  bool valid[TAA_ROWS_PER_THREAD];
  float c[TAA_ROWS_PER_THREAD][3];
  float base_y = 3.0e38f, base_x = 3.0e38f;
#pragma unroll
  for (int k = 0; k < TAA_ROWS_PER_THREAD; ++k) {
    const int y = tile_y + threadIdx.y + 8 * k;  // the band's row
    const bool in_frame = y < p.rows;            // the band's own extent
    const size_t o = (size_t)y * p.width + x;
    const float yf = (float)(y + p.row0);        // the global row
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
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) c[k][ch] = in_frame ? cur[o * 3 + ch] : 0.0f;
  }

  // ---- the TPU's history window: base and validity rule ----
  block_min2(base_y, base_x, red);
  int ry0 = min(max((int)floorf(base_y) - 2, 0), p.hist_rows - p.win_rows);
  ry0 = (ry0 >> 3) << 3;
  int rx0 = min(max((int)floorf(base_x) - 8, 0), p.width - p.win_cols);
  rx0 = (rx0 >> 7) << 7;
  const float rmax = (float)((double)p.win_rows - 1.001);
  const float cmax = (float)((double)p.win_cols - 1.001);

  // ---- bilinear history (direct gathers) and depth validity ----
  float h[TAA_ROWS_PER_THREAD][3];
#pragma unroll
  for (int k = 0; k < TAA_ROWS_PER_THREAD; ++k) {
    float ryf = sub(py[k], (float)ry0);
    float rxf = sub(px[k], (float)rx0);
    bool v = valid[k] && ryf >= 0.0f && ryf <= rmax && rxf >= 0.0f && rxf <= cmax;
    ryf = fminf(fmaxf(ryf, 0.0f), rmax);
    rxf = fminf(fmaxf(rxf, 0.0f), cmax);
    const float r0f = floorf(ryf), c0f = floorf(rxf);
    const float wy = sub(ryf, r0f), wx = sub(rxf, c0f);
    const size_t o0 = (size_t)(ry0 + (int)r0f) * p.width + (size_t)(rx0 + (int)c0f);
    const size_t o1 = o0 + p.width;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float h0 = lerp_rows(__ldg(hist + o0 * 3 + ch), __ldg(hist + (o0 + 1) * 3 + ch), wx);
      const float h1 = lerp_rows(__ldg(hist + o1 * 3 + ch), __ldg(hist + (o1 + 1) * 3 + ch), wx);
      h[k][ch] = lerp_rows(h0, h1, wy);
    }
    const float d0 = lerp_rows(fminf(__ldg(hist_depth + o0), 1.0e7f),
                               fminf(__ldg(hist_depth + o0 + 1), 1.0e7f), wx);
    const float d1 = lerp_rows(fminf(__ldg(hist_depth + o1), 1.0e7f),
                               fminf(__ldg(hist_depth + o1 + 1), 1.0e7f), wx);
    const float hist_ld = lerp_rows(d0, d1, wy);
    valid[k] = v && fabsf(sub(hist_ld, ld[k])) <= mul(p.depth_eps, fmaxf(ld[k], 1e-3f));
  }

  // ---- 3 x 3 tile-local clamp and blend, one channel at a time ----
  const float ninth = (float)(1.0 / 9.0);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    __syncthreads();  // the previous channel's readers are done with plane
#pragma unroll
    for (int k = 0; k < TAA_ROWS_PER_THREAD; ++k) plane[threadIdx.y + 8 * k][tx] = c[k][ch];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TAA_ROWS_PER_THREAD; ++k) {
      const int ly = threadIdx.y + 8 * k;
      const float centre = c[k][ch];
      float lo = centre, hi = centre, m1 = centre, m2 = mul(centre, centre);
      // taps in the TPU's roll order: rows y+1, y, y-1; columns x+1, x, x-1
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          if (a == 1 && b == 1) continue;
          const int ny = ly + 1 - a, nx = tx + 1 - b;
          const bool ok = ny >= 0 && ny < TAA_TILE_ROWS && nx >= 0 && nx < TAA_TILE_COLS &&
                          tile_y + ny < p.rows;
          const float n = ok ? plane[ny][nx] : centre;
          if (p.variance) {
            m1 = add(m1, n);
            m2 = add(m2, mul(n, n));
          } else {
            lo = fminf(lo, n);
            hi = fmaxf(hi, n);
          }
        }
      }
      if (p.variance) {
        const float mu = mul(m1, ninth);
        const float sigma = __fsqrt_rn(fmaxf(sub(mul(m2, ninth), mul(mu, mu)), 0.0f));
        lo = sub(mu, mul(p.clamp_gamma, sigma));
        hi = add(mu, mul(p.clamp_gamma, sigma));
      }
      const float hc = fminf(fmaxf(h[k][ch], lo), hi);
      const float a = valid[k] ? p.blend : 1.0f;
      const int y = tile_y + ly;
      if (y < p.rows)
        out[((size_t)y * p.width + x) * 3 + ch] = add(mul(centre, a), mul(hc, sub(1.0f, a)));
    }
  }
#pragma unroll
  for (int k = 0; k < TAA_ROWS_PER_THREAD; ++k) {
    const int y = tile_y + threadIdx.y + 8 * k;
    if (y >= p.rows) continue;
    const size_t o = (size_t)y * p.width + x;
    depth_out[o] = ld[k];  // min(linear depth, 1e7): the next frame's history depth
    if (valid_out) valid_out[o] = valid[k];
  }
}

// Launcher: plain C interface for ctypes.  Returns cudaGetLastError() after
// the launch (0 on success), or -1 for shapes the kernel does not take.
// cur, linear_depth, out, depth_out (and valid): planes of the struct's rows;
// history, history_depth: planes of its hist_rows.  history_depth may be
// linear_depth itself (no history depth yet); valid: nullptr, or a byte
// plane that takes each pixel's validity.
extern "C" int taa_launch(const TaaParams* params, const float* cur, const float* linear_depth,
                          const float* history, const float* history_depth, float* out,
                          float* depth_out, unsigned char* valid, void* stream) {
  const TaaParams& p = *params;
  if (p.height < 1 || p.rows < 8 || p.rows % 8 || p.width < 128 || p.width % 128 ||
      p.hist_rows < 8 || p.hist_rows % 8 || p.win_rows < 8 || p.win_rows > p.hist_rows ||
      p.win_cols < 128 || p.win_cols > p.width)
    return -1;
  dim3 block(TAA_TILE_COLS, TAA_TILE_ROWS / TAA_ROWS_PER_THREAD, 1);
  dim3 grid(p.width / TAA_TILE_COLS, (p.rows + TAA_TILE_ROWS - 1) / TAA_TILE_ROWS, 1);
  taa_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(p, cur, linear_depth, history,
                                                        history_depth, out, depth_out, valid);
  return (int)cudaGetLastError();
}

// sizeof the launch struct, so the wrapper can check its ctypes mirror
extern "C" int taa_params_size(void) { return (int)sizeof(TaaParams); }
