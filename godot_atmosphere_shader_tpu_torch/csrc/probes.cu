// Measurement probes for NVIDIA Hopper (sm_90a).
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
//
// Built with the other kernels (ops/kernels/library.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -fmad=true -c -o probes.o probes.cu

#include <cuda_runtime.h>

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
