// Sparse matrix times dense matrix Y = A X, f64 or complex128, over the
// matrix's live entries.
//
// Replaces: russell_tpu/sparse/kernels.py, _bsr_matmat_pallas (the Pallas
// TPU kernel: the grid of _bsr_matvec_pallas with (BN, M) panels of X,
// each (8, 128) block times its panel on the MXU, the (BM, M) output block
// accumulated across the sequential slot axis).
//
// As bsr_spmv.cu, it reads the matrix's LiveLayout (SELL-32 of the nonzero
// entries of blocks * mask, russell_tpu_torch/sparse/kernels.py) and never
// the blocks, which hold about 99 % zeros on a banded matrix. X is
// (n_cols, M) row-major, Y is (n_rows, M).
//
// What bounds it on an H100: each live entry (12 bytes) does 2 M flops
// against one row of X (8 M bytes) — 0.25 flop per byte of X touched — and
// X is shared by every row whose entries name its row. Far below the f64
// ridge (~20 flop/byte), so HBM bytes bound it: 12 per live entry, the row
// structure, X read once and Y written once. X (67 MB at M 16 on the
// npoint-513 Brusselator) exceeds the 50 MB L2, but the rows of a banded
// matrix name a few moving windows of X, so its re-reads come mostly from
// L1 and L2.
//
// Design: a group of G lanes per row, G the power of two at or above
// min(M, 32) — a half-warp per row at M 16. Lane c of a group keeps
// Y[row, c + G q] for q < CPL in registers (CPL 1, 2 or 4 from M), and a
// grid column of CTAs takes each further G CPL columns of Y. At step k
// the group reads entry k of its row (one value and one column, the same
// address for all its lanes, cached in L1 for the CTA's other rows) and a
// coalesced 8 G-byte piece of that row of X through the read-only path.
// Four steps' loads go out before their FMAs; each Y entry sums its row's
// entries in column order, fixed, and is written once, coalesced: no
// atomics, deterministic output. Any M >= 1. Offsets are 64-bit.
//
// complex128 (value.cuh): the same kernel over 16-byte values, each
// product written out with four FMAs into the accumulator.

#include <cuda_runtime.h>

#include "value.cuh"

namespace {

constexpr int kSliceRows = 32;
constexpr int kUnroll = 4;
constexpr int kThreads = 256;

template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
    sell_spmm_kernel(const T* __restrict__ val, const int* __restrict__ col,
                     const long long* __restrict__ slice_off,
                     const T* __restrict__ X, int n_rows, int n_slices, int m,
                     int log2g, T* __restrict__ Y) {
  const int g = 1 << log2g;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long row = t >> log2g;     // in the ragged slice's padded rows
  if (row >= (long long)n_slices * kSliceRows) return;
  const int c0 = (int)(t & (g - 1)) + (int)blockIdx.y * g * CPL;
  const long long s = row / kSliceRows;
  const int lane = (int)(row % kSliceRows);
  const long long off = slice_off[s];
  const long long width = (slice_off[s + 1] - off) / kSliceRows;
  const T* v = val + off + lane;
  const int* c = col + off + lane;
  T acc[CPL];
#pragma unroll
  for (int q = 0; q < CPL; ++q) acc[q] = vzero<T>();
  for (long long k = 0; k < width; k += kUnroll) {
    T a[kUnroll], xv[kUnroll][CPL];
    int j[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = k + u < width;
      a[u] = live ? vldg(v + (k + u) * kSliceRows) : vzero<T>();
      j[u] = live ? __ldg(c + (k + u) * kSliceRows) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const T* xr = X + (long long)j[u] * m;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int cc = c0 + q * g;
        xv[u][q] = k + u < width && cc < m ? vldg(xr + cc) : vzero<T>();
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (k + u < width) {
#pragma unroll
        for (int q = 0; q < CPL; ++q) acc[q] = vfma(a[u], xv[u][q], acc[q]);
      }
  }
  if (row >= n_rows) return;
  T* yr = Y + row * m;
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    const int cc = c0 + q * g;
    if (cc < m) yr[cc] = acc[q];
  }
}

template <typename T, int CPL>
int launch_cpl(const T* val, const int* col, const long long* slice_off,
               const T* X, int n_rows, int n_slices, int m, int log2g, T* Y,
               cudaStream_t stream) {
  const long long threads = ((long long)n_slices * kSliceRows) << log2g;
  const long long bx = (threads + kThreads - 1) / kThreads;
  const long long by = (m + (CPL << log2g) - 1) / (CPL << log2g);
  if (bx > 0x7fffffffLL || by > 65535) return (int)cudaErrorInvalidValue;
  sell_spmm_kernel<T, CPL><<<dim3((unsigned)bx, (unsigned)by), kThreads, 0,
                             stream>>>(val, col, slice_off, X, n_rows,
                                       n_slices, m, log2g, Y);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* val, const int* col, const long long* slice_off,
           const T* X, int n_rows, int n_slices, int m, T* Y, void* stream) {
  if (n_rows <= 0 || m <= 0) return (int)cudaGetLastError();
  if (n_slices != (n_rows + kSliceRows - 1) / kSliceRows)
    return (int)cudaErrorInvalidValue;
  int log2g = 0;
  while ((1 << log2g) < m && log2g < 5) ++log2g;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 32)
    return launch_cpl<T, 1>(val, col, slice_off, X, n_rows, n_slices, m,
                            log2g, Y, st);
  if (m <= 64)
    return launch_cpl<T, 2>(val, col, slice_off, X, n_rows, n_slices, m,
                            log2g, Y, st);
  return launch_cpl<T, 4>(val, col, slice_off, X, n_rows, n_slices, m, log2g,
                          Y, st);
}

}  // namespace

// Return a cudaError_t code (0 = launched). Launch on `stream`, do not
// synchronise and allocate nothing: the caller owns `Y` (n_rows, m).
// slice_off holds n_slices + 1 offsets; val and col slice_off[n_slices]
// slots each.
extern "C" int bsr_spmm_f64(const double* val, const int* col,
                            const long long* slice_off, const double* X,
                            int n_rows, int n_slices, int m, double* Y,
                            void* stream) {
  return launch(val, col, slice_off, X, n_rows, n_slices, m, Y, stream);
}

extern "C" int bsr_spmm_c128(const double2* val, const int* col,
                             const long long* slice_off, const double2* X,
                             int n_rows, int n_slices, int m, double2* Y,
                             void* stream) {
  return launch(val, col, slice_off, X, n_rows, n_slices, m, Y, stream);
}
