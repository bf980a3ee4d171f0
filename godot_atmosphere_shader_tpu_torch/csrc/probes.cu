// Measurement probes for NVIDIA Hopper (sm_90a).
//
// peak_kernel: the card's arithmetic ceilings (T2).  Replaces the TPU
//   Pallas probe tools/vpu_peak.py::_run_chain (pallas_call at
//   vpu_peak.py:86; its body _chain_kernel, :57-76)
// PEAK_CHAINS independent register-resident chains per thread, each
// advanced INNER times per loop iteration: y = fmaf(y, a, b) (FFMA:
// the fp32 peak, 2 operations per step), y = expf(-|y|) (the accurate
// expf, as JAX's exp chain), y = __expf(-|y|) (the raw SFU rate: one
// MUFU.EX2 and a multiply) or y = y * a + b on uint32 (IMAD: the INT32
// rate, 2 operations per step).  a and b are one (16, 128) plane, as
// _chain_kernel's; thread i takes element i % 2048.  Chains start at
// a * (0.4 + 0.01 k) + b and are summed in chain order.  Plain version:
// ops/kernels/probes.py::chains_plain.
// What bounds it: the operations themselves, by design (no memory traffic
// in the loop; 16 chains hide the FMA pipeline's latency).  The loop's own
// three instructions (add, compare, branch) take issue slots from the
// chains: the fma and IMAD chains take PEAK_INNER_ALU = 64 steps per
// iteration (3 instructions to 1,024, 0.3 %), the exp chains PEAK_INNER_SFU
// = 8 (the SFU, not issue, bounds them; a longer body would only grow the
// code past the instruction cache).  The grid fills
// every SM several times over and the loop runs tens of ms, so the ctypes
// launch interval is under 1 % of the time.
//
// fill_kernel: the launch floor of a flight.  Replaces the TPU Pallas probe
//   tools/profile_small.py::trivial_scan_totals.run (pallas_call at
//   profile_small.py:101)
// a do-nothing tile kernel that writes one scalar to every pixel of an
// (h, w) f32 plane on the 32 x 128 tile grid.  Launched K times back to
// back, its time per launch is the least a flight frame can cost on this
// card.  Plain version: torch.full (ops/kernels/probes.py::fill_plain).
//
// What bounds it: bytes (4 per pixel written; 8.3 MB at 1080p, 2.5 us at
// 3.35 TB/s) plus the launch itself.  Design: one block of 128 x 8 threads
// per tile, four rows per thread, a warp writes 128 contiguous bytes.
// 16-byte stores (a float4 a thread and row where the rows start aligned)
// were measured and not kept: 3.220 against 3.228 us of device time at
// 1080p, within the spread of either (compare_megakernel.py, six passes).
// The launch's host side is the port's one route
// (ops/kernels/library.py::launch).
//
// Built with the other kernels (ops/kernels/library.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -fmad=true -c -o probes.o probes.cu

#include <cuda_runtime.h>
#include <stdint.h>

#define PROBE_TILE_ROWS 32
#define PROBE_TILE_COLS 128
#define PROBE_ROWS_PER_THREAD 4

__global__ void __launch_bounds__(PROBE_TILE_COLS * (PROBE_TILE_ROWS / PROBE_ROWS_PER_THREAD))
    fill_kernel(float value, float* __restrict__ out, int height, int width) {
  const int x = blockIdx.x * PROBE_TILE_COLS + threadIdx.x;
  if (x >= width) return;
#pragma unroll
  for (int k = 0; k < PROBE_ROWS_PER_THREAD; ++k) {
    const int y = blockIdx.y * PROBE_TILE_ROWS + threadIdx.y + 8 * k;
    if (y < height) out[(size_t)y * width + x] = value;
  }
}

// Launcher: plain C interface for ctypes; returns cudaGetLastError() after
// the launch (0 on success), or -1 for an empty plane.
extern "C" int fill_launch(float value, float* out, int height, int width, void* stream) {
  if (height < 1 || width < 1) return -1;
  dim3 block(PROBE_TILE_COLS, PROBE_TILE_ROWS / PROBE_ROWS_PER_THREAD, 1);
  dim3 grid((width + PROBE_TILE_COLS - 1) / PROBE_TILE_COLS,
            (height + PROBE_TILE_ROWS - 1) / PROBE_TILE_ROWS, 1);
  fill_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(value, out, height, width);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// T2: the peak probe

#define PEAK_CHAINS 16
#define PEAK_INNER_ALU 64
#define PEAK_INNER_SFU 8
#define PEAK_PLANE 2048
#define PEAK_THREADS 256

template <int OP>
__global__ void __launch_bounds__(PEAK_THREADS)
    peak_kernel(const float* __restrict__ a_in, const float* __restrict__ b_in, int iters,
                float* __restrict__ out) {
  constexpr int INNER = (OP == 0 || OP == 3) ? PEAK_INNER_ALU : PEAK_INNER_SFU;
  const int i = blockIdx.x * PEAK_THREADS + threadIdx.x;
  const float a = a_in[i % PEAK_PLANE], b = b_in[i % PEAK_PLANE];
  if (OP == 3) {
    const uint32_t ua = __float_as_uint(a) | 1u, ub = __float_as_uint(b);
    uint32_t y[PEAK_CHAINS];
#pragma unroll
    for (int k = 0; k < PEAK_CHAINS; ++k) y[k] = ua * (uint32_t)(k + 1) + ub;
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int j = 0; j < INNER; ++j) {
#pragma unroll
        for (int k = 0; k < PEAK_CHAINS; ++k) y[k] = y[k] * ua + ub;
      }
    }
    uint32_t acc = 0u;
#pragma unroll
    for (int k = 0; k < PEAK_CHAINS; ++k) acc += y[k];
    out[i] = (float)(acc >> 8);
    return;
  }
  float y[PEAK_CHAINS];
#pragma unroll
  for (int k = 0; k < PEAK_CHAINS; ++k) y[k] = __fadd_rn(__fmul_rn(a, (float)(0.4 + 0.01 * k)), b);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < INNER; ++j) {
#pragma unroll
      for (int k = 0; k < PEAK_CHAINS; ++k) {
        if (OP == 0) y[k] = fmaf(y[k], a, b);
        if (OP == 1) y[k] = expf(-fabsf(y[k]));
        if (OP == 2) y[k] = __expf(-fabsf(y[k]));
      }
    }
  }
  float acc = y[0];
#pragma unroll
  for (int k = 1; k < PEAK_CHAINS; ++k) acc = __fadd_rn(acc, y[k]);
  out[i] = acc;
}

// op: 0 fma, 1 exp, 2 __expf, 3 imad; out: blocks * PEAK_THREADS floats.
// Returns cudaGetLastError() after the launch, or -1 for bad arguments.
extern "C" int peak_launch(int op, const float* a, const float* b, int iters, int blocks,
                           float* out, void* stream) {
  if (op < 0 || op > 3 || iters < 0 || blocks < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (op == 0) peak_kernel<0><<<blocks, PEAK_THREADS, 0, s>>>(a, b, iters, out);
  if (op == 1) peak_kernel<1><<<blocks, PEAK_THREADS, 0, s>>>(a, b, iters, out);
  if (op == 2) peak_kernel<2><<<blocks, PEAK_THREADS, 0, s>>>(a, b, iters, out);
  if (op == 3) peak_kernel<3><<<blocks, PEAK_THREADS, 0, s>>>(a, b, iters, out);
  return (int)cudaGetLastError();
}
