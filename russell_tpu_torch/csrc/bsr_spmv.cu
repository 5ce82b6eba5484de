// Sparse matrix-vector product y = A x, f64 or complex128, over the
// matrix's live entries.
//
// Replaces: russell_tpu/sparse/kernels.py, _bsr_matvec_pallas (the Pallas
// TPU kernel: grid (block row, padded slot), block-column ids scalar-
// prefetched to select the x panel, each (8, 128) block fed to the MXU and
// the output block row accumulated across the sequential slot axis).
//
// The TPU kernel's (8, 128) blocks suit the MXU and VMEM; they mean nothing
// to an SM, and on a banded matrix they are mostly zeros: the Brusselator
// Jacobian has about 6 nonzeros a row, so its 8x128 blocks are 1.1 %
// nonzero. This kernel does not read the blocks. It reads the matrix's
// LiveLayout (russell_tpu_torch/sparse/kernels.py, derived once per matrix
// from blocks * mask): sliced ELLPACK of 32 rows a slice (SELL-32), entry
// k of row 32 s + l at val/col[slice_off[s] + 32 k + l], a slice as wide
// as its longest row, pads holding value 0 and their row's last column.
//
// What bounds it on an H100: each live entry (8-byte value, 4-byte column)
// is read once and used for one FMA with a gathered x entry — 2 flops per
// 12 bytes, about 0.17 flop/byte, far below the f64 ridge (~20 flop/byte
// at 67 TFLOP/s FP64 tensor core and 3.35 TB/s). HBM bytes bound it: 12
// per live entry, the row structure, x read once and y written once.
//
// Design: one warp per slice, one lane per row. At step k the 32 lanes
// read entry k of 32 consecutive rows from consecutive addresses: one
// 256-byte (values) and one 128-byte (columns) transaction. Values and
// columns are used once, so they are loaded on the non-coherent path
// without allocating in L1 (ld.global.nc.L1::no_allocate). x is gathered
// through the read-only path (__ldg): the rows of a slice of a banded
// matrix touch a few short windows of x, which stay in L1 and L2. Eight
// steps' loads are issued before their FMAs to keep bytes in flight; the
// sum still runs over the row's entries in column order, fixed, and y is
// written once: no atomics, deterministic output. Slice offsets are 64-bit
// (the slots of a large matrix pass 2^31).
//
// What SELL-32 costs where rows differ in length: a slice is as wide as its
// longest row, so one row of L entries gives its slice 32 L slots (31 L of
// them pads: bytes of the layout) and its warp L steps with the other 31
// lanes reading pads (cached, their row's last column). The other slices
// are untouched. On the Brusselator Jacobian rows hold 5-6 entries and
// pads are a few percent of the slots.
//
// complex128 (value.cuh): the same kernel over 16-byte values, each
// product written out with four FMAs into the accumulator; 20 bytes a live
// entry, 8 flops.

#include <cuda_runtime.h>

#include "value.cuh"

namespace {

constexpr int kSliceRows = 32;
constexpr int kUnroll = 8;
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sell_spmv_kernel(const T* __restrict__ val, const int* __restrict__ col,
                     const long long* __restrict__ slice_off,
                     const T* __restrict__ x, int n_rows, int n_slices,
                     T* __restrict__ y) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long s = t / kSliceRows;
  if (s >= n_slices) return;
  const int lane = (int)(t % kSliceRows);
  const long long off = slice_off[s];
  const long long width = (slice_off[s + 1] - off) / kSliceRows;
  const T* v = val + off + lane;
  const int* c = col + off + lane;
  T acc = vzero<T>();
  for (long long k = 0; k < width; k += kUnroll) {
    T a[kUnroll], xv[kUnroll];
    int j[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = k + u < width;
      a[u] = live ? load_once(v + (k + u) * kSliceRows) : vzero<T>();
      j[u] = live ? load_once(c + (k + u) * kSliceRows) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      xv[u] = k + u < width ? vldg(x + j[u]) : vzero<T>();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (k + u < width) acc = vfma(a[u], xv[u], acc);
  }
  const long long row = s * kSliceRows + lane;
  if (row < n_rows) y[row] = acc;
}

template <typename T>
int launch(const T* val, const int* col, const long long* slice_off,
           const T* x, int n_rows, int n_slices, T* y, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  if (n_slices != (n_rows + kSliceRows - 1) / kSliceRows)
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)n_slices * kSliceRows;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  sell_spmv_kernel<T><<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      val, col, slice_off, x, n_rows, n_slices, y);
  return (int)cudaGetLastError();
}

}  // namespace

// Return a cudaError_t code (0 = launched). Launch on `stream`, do not
// synchronise and allocate nothing: the caller owns `y` (n_rows values).
// slice_off holds n_slices + 1 offsets; val and col slice_off[n_slices]
// slots each.
extern "C" int bsr_spmv_f64(const double* val, const int* col,
                            const long long* slice_off, const double* x,
                            int n_rows, int n_slices, double* y,
                            void* stream) {
  return launch(val, col, slice_off, x, n_rows, n_slices, y, stream);
}

extern "C" int bsr_spmv_c128(const double2* val, const int* col,
                             const long long* slice_off, const double2* x,
                             int n_rows, int n_slices, double2* y,
                             void* stream) {
  return launch(val, col, slice_off, x, n_rows, n_slices, y, stream);
}
