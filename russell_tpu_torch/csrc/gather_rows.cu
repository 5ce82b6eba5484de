// Row gather out[k, :] = src[idx[k], :] of f64 rows, for the SPLU
// factorize row step.
//
// Replaces: russell_tpu/sparse/splu.py, _gather_rows (the Pallas TPU
// kernel: one async DMA per gathered row, issued in chunks of P rows with
// one completion semaphore, rows viewed as (8, W/8) tiles).
//
// What bounds it on an H100 SXM (NVIDIA H100 80GB HBM3, 700 W): it moves
// bytes only. Rows are W = 1024 or 4096 doubles (8 KB or 32 KB); a call
// gathers `len` rows (1 to 1024; median 36 at npoint 129, 142 at 513) from
// few distinct sources (10 on average at npoint 129), which the L2 cache
// serves, so the writes set the bound: up to 8 MB or 32 MB at 3.35 TB/s.
//
// Design: the earlier kernel gave each 256-thread CTA four whole rows and
// each thread one 16-byte load in flight, so a 36-row call ran on 9 CTAs of
// a 132-SM card. Here each CTA copies one (row, chunk) piece of 128 * U
// 16-byte words: every thread issues its U independent loads before its
// stores. The host picks U in {4, 2, 1} (chunks of 8, 4 or 2 KB), the
// largest that still gives 2 * 132 CTAs, so a 36-row call fills the card
// and a 1,024-row call keeps 8 KB per CTA in flight. A design with
// Hopper's bulk copy engine (cp.async.bulk global -> shared -> global, one
// thread per CTA) was measured against this one and was no faster
// (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kFillCtas = 2 * 132;

// words (16 bytes) per thread: the largest U that still gives kFillCtas
int pick_u(int n_rows, int w2) {
  for (int u = 4; u > 1; u /= 2) {
    const long long per_row = (w2 + kThreads * u - 1) / (kThreads * u);
    if ((long long)n_rows * per_row >= kFillCtas) return u;
  }
  return 1;
}

template <int U>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const double2* __restrict__ src,
                   const int* __restrict__ idx, int w2, int n_chunks,
                   double2* __restrict__ out) {
  constexpr int CH = kThreads * U;   // words per chunk
  const int k = blockIdx.x / n_chunks;
  const int ch = blockIdx.x - k * n_chunks;
  const int base = ch * CH + threadIdx.x;
  const double2* s = src + (size_t)__ldg(idx + k) * w2;
  double2* d = out + (size_t)k * w2;
  double2 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = base + u * kThreads;
    if (e < w2) v[u] = s[e];
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = base + u * kThreads;
    if (e < w2) __stcs(d + e, v[u]);
  }
}

template <int U>
cudaError_t launch(const double* src, const int* idx, int n_rows, int w2,
                   double* out, cudaStream_t stream) {
  const int n_chunks = (w2 + kThreads * U - 1) / (kThreads * U);
  const long long grid = (long long)n_rows * n_chunks;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  gather_rows_kernel<U><<<(unsigned)grid, kThreads, 0, stream>>>(
      reinterpret_cast<const double2*>(src), idx, w2, n_chunks,
      reinterpret_cast<double2*>(out));
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 = launched). `width` (doubles per row) must
// be even and both pointers 16-byte aligned; the caller checks. Launches on
// `stream`, does not synchronise and allocates nothing.
extern "C" int gather_rows_f64(const double* src, const int* idx, int n_rows,
                               int width, double* out, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  if (width <= 0 || width % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w2 = width / 2;
  switch (pick_u(n_rows, w2)) {
    case 4: return (int)launch<4>(src, idx, n_rows, w2, out, s);
    case 2: return (int)launch<2>(src, idx, n_rows, w2, out, s);
    default: return (int)launch<1>(src, idx, n_rows, w2, out, s);
  }
}

