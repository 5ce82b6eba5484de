// Row gather out[k, :] = src[idx[k], :] of f64 or f32 rows, for the SPLU
// factorize row step; over a lane dimension, out[l, k, :] = src[l, idx[k], :]
// for the L matrices of a batch factorized over one plan (one index list).
// The f32 build (mixed-precision factors) is the same copy of 16-byte
// words: four values a word where the f64 build moves two.
//
// Replaces: russell_tpu/sparse/splu.py, _gather_rows (the Pallas TPU
// kernel: one async DMA per gathered row, issued in chunks of P rows with
// one completion semaphore, rows viewed as (8, W/8) tiles).
//
// What bounds it on an H100 SXM (NVIDIA H100 80GB HBM3, 700 W): it moves
// bytes only. Rows are W = 1024 or 4096 values (8 KB or 32 KB at f64, 4 KB
// or 16 KB at f32); a call
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
// (PERF.md). A batch adds a grid dimension over its lanes (blockIdx.y),
// each lane's source and output offset by their lane strides, so B lanes
// are one launch and each lane copies what a one-lane launch copies.

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
                   long long src_lane, long long out_lane,
                   double2* __restrict__ out) {
  constexpr int CH = kThreads * U;   // words per chunk
  const int k = blockIdx.x / n_chunks;
  const int ch = blockIdx.x - k * n_chunks;
  const int base = ch * CH + threadIdx.x;
  const double2* s =
      src + blockIdx.y * src_lane + (size_t)__ldg(idx + k) * w2;
  double2* d = out + blockIdx.y * out_lane + (size_t)k * w2;
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

// w2 and src_lane in 16-byte words (a double2 holds the bits of two
// doubles or of four floats: the kernel only moves them)
template <int U>
cudaError_t launch(const void* src, const int* idx, int n_rows, int w2,
                   int lanes, long long src_lane, void* out,
                   cudaStream_t stream) {
  const int n_chunks = (w2 + kThreads * U - 1) / (kThreads * U);
  const long long grid = (long long)n_rows * n_chunks;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  gather_rows_kernel<U><<<dim3((unsigned)grid, (unsigned)lanes), kThreads, 0,
                          stream>>>(
      static_cast<const double2*>(src), idx, w2, n_chunks, src_lane,
      (long long)n_rows * w2, static_cast<double2*>(out));
  return cudaGetLastError();
}

// `per_word` values of `width` make a 16-byte word
int gather(const void* src, const int* idx, int n_rows, int width,
           int per_word, int lanes, long long src_lane, void* out,
           void* stream) {
  if (n_rows <= 0 || lanes == 0) return (int)cudaGetLastError();
  if (width <= 0 || width % per_word || src_lane % per_word || lanes < 0 ||
      lanes > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w2 = width / per_word;
  const long long lane2 = src_lane / per_word;
  // the CTAs of all lanes fill the card
  switch (pick_u(n_rows * lanes, w2)) {
    case 4:
      return (int)launch<4>(src, idx, n_rows, w2, lanes, lane2, out, s);
    case 2:
      return (int)launch<2>(src, idx, n_rows, w2, lanes, lane2, out, s);
    default:
      return (int)launch<1>(src, idx, n_rows, w2, lanes, lane2, out, s);
  }
}

}  // namespace

// Returns a cudaError_t code (0 = launched). `width` (doubles per row) and
// `src_lane` (doubles from one lane's source rows to the next's) must be
// even and both pointers 16-byte aligned; the caller checks. `out` is
// (lanes, n_rows, width) contiguous. Launches on `stream`, does not
// synchronise and allocates nothing.
extern "C" int gather_rows_f64(const double* src, const int* idx, int n_rows,
                               int width, int lanes, long long src_lane,
                               double* out, void* stream) {
  return gather(src, idx, n_rows, width, 2, lanes, src_lane, out, stream);
}

// gather_rows_f64 on f32 rows: `width` and `src_lane` (floats) multiples of
// 4, both pointers 16-byte aligned.
extern "C" int gather_rows_f32(const float* src, const int* idx, int n_rows,
                               int width, int lanes, long long src_lane,
                               float* out, void* stream) {
  return gather(src, idx, n_rows, width, 4, lanes, src_lane, out, stream);
}
