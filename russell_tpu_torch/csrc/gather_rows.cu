// Row gather out[k, :] = src[idx[k], :] of f64 rows, for the SPLU
// factorize row step.
//
// Replaces: russell_tpu/sparse/splu.py, _gather_rows (the Pallas TPU
// kernel: one async DMA per gathered row, issued in chunks of P rows with
// one completion semaphore, rows viewed as (8, W/8) tiles).
//
// What bounds it on an H100: it moves bytes only (W = 1024 or 4096 doubles,
// 8 KB or 32 KB per row, read once and written once), so device memory
// bandwidth (3.35 TB/s) bounds it; a row step gathers up to TL = 1024 rows,
// 8 MB or 32 MB each way.
//
// Design: the TPU needed explicit DMA descriptors and 8-row-aligned tiles;
// on Hopper plain loads do the job. Each CTA of 256 threads copies
// kRows rows; within a row, neighbouring threads move neighbouring 16-byte
// double2 words, so every warp reads and writes whole 512-byte runs. The
// index is read once per row by every thread (a broadcast from L1).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const double2* __restrict__ src,
                   const int* __restrict__ idx, int n_rows, int w2,
                   double2* __restrict__ out) {
  const int k0 = blockIdx.x * kRows;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int k = k0 + r;
    if (k >= n_rows) return;
    const double2* s = src + (size_t)idx[k] * w2;
    double2* d = out + (size_t)k * w2;
    for (int e = threadIdx.x; e < w2; e += kThreads) d[e] = s[e];
  }
}

}  // namespace

// Returns a cudaError_t code (0 = launched). `width` (doubles per row) must
// be even and both pointers 16-byte aligned; the caller checks. Launches on
// `stream`, does not synchronise and allocates nothing.
extern "C" int gather_rows_f64(const double* src, const int* idx, int n_rows,
                               int width, double* out, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  if (width <= 0 || width % 2) return (int)cudaErrorInvalidValue;
  const int grid = (n_rows + kRows - 1) / kRows;
  gather_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const double2*>(src), idx, n_rows, width / 2,
      reinterpret_cast<double2*>(out));
  return (int)cudaGetLastError();
}
