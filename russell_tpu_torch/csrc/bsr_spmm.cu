// BSR sparse matrix times dense matrix Y = A X, f64.
//
// Replaces: russell_tpu/sparse/kernels.py, _bsr_matmat_pallas (the Pallas
// TPU kernel: the grid of _bsr_matvec_pallas with (BN, M) panels of X,
// the (BM, M) output block zeroed at slot 0 and accumulated across the
// sequential slot axis).
//
// A is stored as in bsr_spmv.cu: blocks (nbr*bpr, BM, BN), col_ids and mask
// (nbr, bpr). X is (n_cols, M) row-major, Y is (n_rows, M). Computes
// Y[r*BM + i][c] = sum_s mask[r,s] * sum_j blocks[r*bpr+s][i][j] *
// X[col_ids[r,s]*BN + j][c], with X read as zero past row n_cols and Y
// written only below row n_rows (the ragged edges are masked here).
//
// What bounds it on an H100: each stored block (8 KB at BM 8, BN 128) is
// read once and does 2*BM*BN*M flops — 32,768 at M 16, 4 flop/byte — while
// the X panels are shared by every block row that uses them (X is 67 MB at
// the npoint-513 Brusselator size, mostly served by the 50 MB L2). That is
// below the f64 ridge (~20 flop/byte at 67 TFLOP/s FP64 tensor core and
// 3.35 TB/s), so device memory bounds it: live blocks plus X and Y.
//
// Design: the TPU's sequential slot axis becomes a loop inside the CTA.
// One CTA per block row; thread t < BM*M owns output (t / M, t % M) and
// keeps it in a register across all slots of the row. Per stored slot
// (pads skipped, uniformly for the CTA) the CTA copies the block and the
// X panel it selects into shared memory — both are contiguous runs in
// device memory, so the copies are coalesced — then every thread does BN
// FMAs from shared memory. No atomics, a fixed summation order,
// deterministic output; Y is written once. Storage offsets are 64-bit.

#include <cuda_runtime.h>

namespace {

__global__ void bsr_spmm_kernel(const double* __restrict__ blocks,
                                const int* __restrict__ col_ids,
                                const double* __restrict__ mask,
                                const double* __restrict__ X, int bpr,
                                int bm, int bn, int m, int n_rows, int n_cols,
                                double* __restrict__ Y) {
  extern __shared__ double smem[];
  double* as = smem;             // (BM, BN) block
  double* xs = smem + bm * bn;   // (BN, M) panel of X
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n_out = bm * m;
  const int oi = tid / m;
  const int oc = tid % m;
  double acc = 0.0;
  for (int s = 0; s < bpr; ++s) {
    const size_t slot = (size_t)r * bpr + s;
    const double w = mask[slot];
    if (w == 0.0) continue;
    const double* a = blocks + slot * bm * bn;
    const long long row0 = (long long)col_ids[slot] * bn;
    const double* xp = X + row0 * m;
    const long long live = ((long long)n_cols - row0) * m;  // X entries left
    for (int e = tid; e < bm * bn; e += nt) as[e] = a[e];
    for (int e = tid; e < bn * m; e += nt) xs[e] = e < live ? xp[e] : 0.0;
    __syncthreads();
    if (tid < n_out) {
      double part = 0.0;
      const double* ar = as + oi * bn;
      for (int j = 0; j < bn; ++j) part = fma(ar[j], xs[j * m + oc], part);
      acc = fma(w, part, acc);
    }
    __syncthreads();
  }
  const long long row = (long long)r * bm + oi;
  if (tid < n_out && row < n_rows) Y[row * m + oc] = acc;
}

}  // namespace

// Returns a cudaError_t code (0 = launched). Launches on `stream`, does not
// synchronise and allocates nothing: the caller owns `Y` (n_rows, m).
extern "C" int bsr_spmm_f64(const double* blocks, const int* col_ids,
                            const double* mask, const double* X, int nbr,
                            int bpr, int bm, int bn, int m, int n_rows,
                            int n_cols, double* Y, void* stream) {
  if (nbr <= 0 || n_rows <= 0 || m <= 0) return (int)cudaGetLastError();
  if (bm <= 0 || bn <= 0 || bpr <= 0 || bm * m > 1024)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(double) * ((size_t)bm * bn + (size_t)bn * m);
  cudaError_t err = cudaFuncSetAttribute(
      bsr_spmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((bm * m + 31) / 32) * 32;
  bsr_spmm_kernel<<<nbr, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      blocks, col_ids, mask, X, bpr, bm, bn, m, n_rows, n_cols, Y);
  return (int)cudaGetLastError();
}
