// BSR sparse matrix-vector product y = A x, f64.
//
// Replaces: russell_tpu/sparse/kernels.py, _bsr_matvec_pallas (the Pallas
// TPU kernel: grid (block row, padded slot), block-column ids scalar-
// prefetched to select the x panel, pad slots masked, the output block row
// zeroed at slot 0 and accumulated across the sequential slot axis).
//
// A is stored as nbr block rows of bpr slots: blocks (nbr*bpr, BM, BN)
// row-major f64, col_ids (nbr, bpr) block-column ids, mask (nbr, bpr) the
// slot weight (1 for a stored block, 0 for a pad; a pad's block is zero and
// its col id 0). Computes y[r*BM + i] = sum_s mask[r,s] *
// sum_j blocks[r*bpr+s][i][j] * x[col_ids[r,s]*BN + j] for rows < n_rows,
// with x read as zero past n_cols (the ragged last panel is masked here,
// not padded by a copy).
//
// What bounds it on an H100: each stored f64 entry is read once and used
// for one FMA — 2 flops per 8 bytes, 0.25 flop/byte, far below the f64
// ridge (~20 flop/byte at 67 TFLOP/s FP64 tensor core and 3.35 TB/s) — so
// device memory bounds it: live block bytes plus x and y over 3.35 TB/s.
//
// Design: the TPU's sequential slot axis becomes a loop inside the CTA.
// One CTA per block row, one warp per row of the block (BM warps, BM <= 32).
// Warp i walks the row's slots in order, skips masked slots (the slot
// weight is uniform across the CTA), reads its BN-double row of the block
// with 16-byte (double2) loads — 32 lanes cover 512 contiguous bytes per
// load — and the matching x entries by col id (x stays in L1/L2: the BM
// warps of a CTA read the same panel). Each lane keeps a partial sum; one
// shuffle reduction per row at the end, and lane 0 writes y once. No
// atomics, a fixed summation order, deterministic output. Storage offsets
// are computed in 64 bits: at npoint 513 the block storage holds about
// 470M doubles, and offsets of larger matrices pass 2^31. BN must be even
// (the double2 loads) and blocks 16-byte aligned; the wrapper checks.

#include <cuda_runtime.h>

namespace {

__global__ void bsr_spmv_kernel(const double* __restrict__ blocks,
                                const int* __restrict__ col_ids,
                                const double* __restrict__ mask,
                                const double* __restrict__ x, int bpr,
                                int bm, int bn, int n_rows, int n_cols,
                                double* __restrict__ y) {
  const int r = blockIdx.x;
  const int i = threadIdx.y;   // row within the block row
  const int lane = threadIdx.x;
  const int row = r * bm + i;
  if (row >= n_rows) return;   // the ragged last block row
  const int bn2 = bn / 2;
  double acc = 0.0;
  for (int s = 0; s < bpr; ++s) {
    const size_t slot = (size_t)r * bpr + s;
    const double m = mask[slot];
    if (m == 0.0) continue;
    const double2* a = reinterpret_cast<const double2*>(
        blocks + (slot * bm + i) * bn);
    const long long c0 = (long long)col_ids[slot] * bn;
    double part = 0.0;
    for (int k = lane; k < bn2; k += 32) {
      const double2 v = a[k];
      const long long j = c0 + 2 * k;
      const double x0 = j < n_cols ? x[j] : 0.0;
      const double x1 = j + 1 < n_cols ? x[j + 1] : 0.0;
      part = fma(v.x, x0, part);
      part = fma(v.y, x1, part);
    }
    acc = fma(m, part, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) y[row] = acc;
}

}  // namespace

// Returns a cudaError_t code (0 = launched). Launches on `stream`, does not
// synchronise and allocates nothing: the caller owns `y` (n_rows doubles).
extern "C" int bsr_spmv_f64(const double* blocks, const int* col_ids,
                            const double* mask, const double* x, int nbr,
                            int bpr, int bm, int bn, int n_rows, int n_cols,
                            double* y, void* stream) {
  if (nbr <= 0 || n_rows <= 0) return (int)cudaGetLastError();
  if (bm <= 0 || bm > 32 || bn <= 0 || bn % 2 || bpr <= 0)
    return (int)cudaErrorInvalidValue;
  bsr_spmv_kernel<<<nbr, dim3(32, bm), 0, static_cast<cudaStream_t>(stream)>>>(
      blocks, col_ids, mask, x, bpr, bm, bn, n_rows, n_cols, y);
  return (int)cudaGetLastError();
}
