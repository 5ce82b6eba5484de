// Numeric phase of the block SpGEMM C = A B, f64.
//
// Replaces: russell_tpu/sparse/kernels.py, _spgemm_pallas (the Pallas TPU
// kernel: one sequential grid step per block product, the output block
// selected by the scalar-prefetched c_idx, zeroed at c_first and
// accumulated across consecutive steps).
//
// The host plan (spgemm_plan) lists the block products sorted by their
// destination C block; c_ptr[c] .. c_ptr[c+1] is block c's range. Computes
//     C[c] = sum_{p in [c_ptr[c], c_ptr[c+1])} A[a_idx[p]] @ B[b_idx[p]]
// with A (·, BM, BK) and B (·, BK, BN) row-major f64 block storage and C
// (n_c, BM, BN). A block without products gets zeros.
//
// What bounds it on an H100: per product it reads two blocks (4 KB at
// 16x16x16) and does 2*BM*BK*BN flops (8,192): 2 flop/byte if every block
// came from device memory. Counting each distinct input block once, the
// npoint-513 Brusselator A·A (about 2.7M products) needs about 22 GFLOP
// (0.33 ms at 67 TFLOP/s FP64 tensor core) against about 2.5 GB of live
// A blocks and C output (0.75 ms at 3.35 TB/s): device memory bounds it.
// Blocks of A reused by neighbouring C blocks of one block row are served
// by L2.
//
// Design: Hopper runs blocks in no order, so the TPU's sequential grid
// becomes one CTA per C block that loops over its own product range (the
// design of splu_pairs.cu): no atomics, no zeroing pass, a fixed summation
// order, deterministic output. Per product the CTA copies both operand
// blocks (contiguous runs) into shared memory with coalesced loads; thread
// t < BM*BN owns C entry (t / BN, t % BN) in a register and does BK FMAs.
// C is written once. Storage offsets are computed in 64 bits: a block
// index times the block size can pass 2^31 elements.

#include <cuda_runtime.h>

namespace {

__global__ void spgemm_blocks_kernel(const double* __restrict__ A,
                                     const double* __restrict__ B,
                                     const int* __restrict__ a_idx,
                                     const int* __restrict__ b_idx,
                                     const int* __restrict__ c_ptr, int bm,
                                     int bk, int bn, double* __restrict__ C) {
  extern __shared__ double smem[];
  double* as = smem;             // (BM, BK)
  double* bs = smem + bm * bk;   // (BK, BN)
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n_out = bm * bn;
  const int oi = tid / bn;
  const int oj = tid % bn;
  const size_t a_sz = (size_t)bm * bk;
  const size_t b_sz = (size_t)bk * bn;
  double acc = 0.0;
  const int p1 = c_ptr[c + 1];
  for (int p = c_ptr[c]; p < p1; ++p) {
    const double* ag = A + (size_t)a_idx[p] * a_sz;
    const double* bg = B + (size_t)b_idx[p] * b_sz;
    for (int e = tid; e < (int)a_sz; e += nt) as[e] = ag[e];
    for (int e = tid; e < (int)b_sz; e += nt) bs[e] = bg[e];
    __syncthreads();
    if (tid < n_out) {
      const double* ar = as + oi * bk;
      for (int k = 0; k < bk; ++k) acc = fma(ar[k], bs[k * bn + oj], acc);
    }
    __syncthreads();
  }
  if (tid < n_out) C[(size_t)c * n_out + tid] = acc;
}

}  // namespace

// Returns a cudaError_t code (0 = launched). Launches on `stream`, does not
// synchronise and allocates nothing: the caller owns `C` (n_c, bm, bn).
extern "C" int spgemm_blocks_f64(const double* A, const double* B,
                                 const int* a_idx, const int* b_idx,
                                 const int* c_ptr, int n_c, int bm, int bk,
                                 int bn, double* C, void* stream) {
  if (n_c <= 0) return (int)cudaGetLastError();
  if (bm <= 0 || bk <= 0 || bn <= 0 || bm * bn > 1024)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(double) * ((size_t)bm * bk + (size_t)bk * bn);
  cudaError_t err = cudaFuncSetAttribute(
      spgemm_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((bm * bn + 31) / 32) * 32;
  spgemm_blocks_kernel<<<n_c, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      A, B, a_idx, b_idx, c_ptr, bm, bk, bn, C);
  return (int)cudaGetLastError();
}
