// Segment-summed block-pair products of one SPLU factorize row, f64.
//
// Replaces: russell_tpu/sparse/splu.py, _pairs_pallas (the Pallas TPU
// kernel, one sequential grid step per pair, which zeroes an output block
// at its segment's first pair and accumulates into it).
//
// Computes, for every output lane s < n_lanes,
//     out[s] = sum_{p in [seg_ptr[s], seg_ptr[s+1])} B[pair_l[p]] @ B[pair_u[p]]
// where B = blocks viewed as (N, BE, BE) row-major f64 tiles. The pairs of
// one lane are contiguous because the schedule sorts pairs by segment; the
// host builds seg_ptr once per plan. Pad pairs (segment = n_lanes) lie past
// seg_ptr[n_lanes] and are never read. A lane without pairs gets zeros.
// BE is 32 (real matrices) or 64 (complex ones, stored as the real
// embedding K = [[R,-I],[I,R]]).
//
// What bounds it on an H100: per pair it reads two tiles (16 KB at BE 32,
// 64 KB at BE 64) and does 2*BE^3 flops (64 K / 512 K) — about 4 and 8
// flops per byte, below the f64 ridge of the card (~20 flops per byte for
// 67 TFLOP/s f64 tensor-core or ~10 for 34 TFLOP/s plain FMA at 3.35 TB/s),
// so device memory and the L2 bound it: a row reads ~C = 2048 pairs, about
// 32 MB (BE 32) or 128 MB (BE 64), many tiles several times.
//
// Design: blocks run in no order on Hopper, so the TPU's sequential grid
// becomes one CTA per output lane that loops over its own pair range: no
// atomics, a fixed summation order, deterministic output. Per pair the
// CTA loads both tiles into shared memory with 16-byte (double2) coalesced
// loads, then each of the 256 threads accumulates a (BE/16) x (BE/16)
// sub-tile in registers with f64 FMAs. Thread (ty, tx) owns rows ty+16r and
// columns tx+16c, so the 16 threads of a half-warp read 16 consecutive
// doubles of the U tile (no bank conflicts) and one broadcast value of the
// L tile. Tensor-core DMMA tiles, cp.async/TMA double buffering of the
// next pair's tiles and fusing `cur - acc` into the epilogue are later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int BE>
__global__ void __launch_bounds__(kThreads)
splu_pairs_kernel(const double* __restrict__ blocks,
                  const int* __restrict__ pair_l,
                  const int* __restrict__ pair_u,
                  const int* __restrict__ seg_ptr,
                  double* __restrict__ out) {
  constexpr int R = BE / 16;            // sub-tile edge per thread
  constexpr int BB = BE * BE;           // doubles per tile
  extern __shared__ double2 smem2[];
  double* ls = reinterpret_cast<double*>(smem2);
  double* us = ls + BB;

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  double acc[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[r][c] = 0.0;

  const int p0 = seg_ptr[lane];
  const int p1 = seg_ptr[lane + 1];
  for (int p = p0; p < p1; ++p) {
    const double2* lg =
        reinterpret_cast<const double2*>(blocks + (size_t)pair_l[p] * BB);
    const double2* ug =
        reinterpret_cast<const double2*>(blocks + (size_t)pair_u[p] * BB);
    double2* ls2 = reinterpret_cast<double2*>(ls);
    double2* us2 = reinterpret_cast<double2*>(us);
    for (int k = tid; k < BB / 2; k += kThreads) {
      ls2[k] = lg[k];
      us2[k] = ug[k];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BE; ++j) {
      double a[R], b[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = ls[(ty + 16 * r) * BE + j];
#pragma unroll
      for (int c = 0; c < R; ++c) b[c] = us[j * BE + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) acc[r][c] = fma(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

  double* o = out + (size_t)lane * BB;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) o[(ty + 16 * r) * BE + tx + 16 * c] = acc[r][c];
}

template <int BE>
cudaError_t launch(const double* blocks, const int* pair_l, const int* pair_u,
                   const int* seg_ptr, int n_lanes, double* out,
                   cudaStream_t stream) {
  const size_t smem = 2 * sizeof(double) * BE * BE;
  cudaError_t err = cudaFuncSetAttribute(
      splu_pairs_kernel<BE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  splu_pairs_kernel<BE><<<n_lanes, kThreads, smem, stream>>>(
      blocks, pair_l, pair_u, seg_ptr, out);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 = launched). Launches on `stream`, does not
// synchronise and allocates nothing: the caller owns `out` (n_lanes, be*be).
extern "C" int splu_pairs_f64(const double* blocks, const int* pair_l,
                              const int* pair_u, const int* seg_ptr,
                              int n_lanes, int be, double* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_lanes <= 0) return (int)cudaGetLastError();
  if (be == 32)
    return (int)launch<32>(blocks, pair_l, pair_u, seg_ptr, n_lanes, out, s);
  if (be == 64)
    return (int)launch<64>(blocks, pair_l, pair_u, seg_ptr, n_lanes, out, s);
  return (int)cudaErrorInvalidValue;
}
