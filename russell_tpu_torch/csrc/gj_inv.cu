// Batched Gauss-Jordan inverse with static pivot clamping, f64: the base
// case (m <= 32) of the pivot-block inverse of both sparse solvers.
//
// Replaces: russell_tpu/sparse/splu.py, _gj_inv (plain XLA, no Pallas:
// 32 unrolled elimination steps of elementwise ops over the batch), which
// splu._inv_block reaches at the bottom of its 2x2 Schur recursion for
// every SPLU diagonal lane and every GRIDMF pivot block. In the port's
// plain version (russell_tpu_torch/sparse/splu.py, _gj_inv_plain) each
// step is about ten torch ops: launched one by one from the host, they
// made the npoint-129 factorize pair wait on ~123k launches.
//
// Per lane: [D | I] (m x 2m), no row interchanges; step j takes the pivot
// p = W[j][j], replaces it when |p| <= delta by delta * p / |p| (delta
// when p is 0: MUMPS-style static pivot clamping), records |p| before the
// clamp and the clamped p, then row = W[j] / p, W -= f (x) row with f the
// pivot column (f[j] = 0), W[j] = row. The result is W's right half. The
// per-lane statistics (log|det|, min|pivot|, n_perturbed, sign) are
// reduced by the caller from the recorded pivots with the same torch code
// as the plain version, so kernel and plain version differ only where the
// elimination rounds differently, and they do not: each product and
// difference is rounded apart (__dmul_rn, __dsub_rn, __ddiv_rn: no FMA
// contraction), in the plain version's order, which is how torch computes
// it elementwise.
//
// What bounds it on an H100: per lane m^2 doubles in, m^2 + 2m out and
// about 4 m^3 flops (2m columns updated in m rows at m steps): at m 32
// 8 KB and 131 kFLOP, 16 flops a byte, below the f64 ridge (~20 at 67
// TFLOP/s and 3.35 TB/s), so bytes bound it in principle; in fact the m
// dependent steps bound it (each waits on the previous one's update).
//
// Design, simple first: one CTA per lane, [D | I] in shared memory (16
// KB at m 32), one thread clamps and records the pivot, the CTA's threads
// form the scaled row and the pivot column, then update every entry of W,
// three barriers a step. A warp per lane in registers, several lanes a
// CTA, is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxM = 32;
constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
    gj_inv_kernel(const double* __restrict__ D,
                  const double* __restrict__ delta, int m,
                  double* __restrict__ Dinv, double* __restrict__ ap_out,
                  double* __restrict__ piv_out) {
  __shared__ double W[kMaxM * 2 * kMaxM];  // row-major, m rows of 2m
  __shared__ double row[2 * kMaxM];
  __shared__ double f[kMaxM];
  __shared__ double s_p;
  const long long lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int w2 = 2 * m;
  const int n = m * w2;
  const double* Dl = D + lane * m * m;
  for (int idx = tid; idx < n; idx += nt) {
    const int i = idx / w2, k = idx - i * w2;
    W[idx] = k < m ? Dl[i * m + k] : (k - m == i ? 1.0 : 0.0);
  }
  const double d = *delta;
  __syncthreads();
  for (int j = 0; j < m; ++j) {
    if (tid == 0) {
      const double pj = W[j * w2 + j];
      const double ap = fabs(pj);
      double p = pj;
      if (ap <= d) {
        const double unit = ap > 0.0 ? __ddiv_rn(pj, fmax(ap, 1e-300)) : 1.0;
        p = __dmul_rn(unit, d);
      }
      ap_out[lane * m + j] = ap;
      piv_out[lane * m + j] = p;
      s_p = p;
    }
    __syncthreads();
    const double p = s_p;
    for (int k = tid; k < w2; k += nt) row[k] = __ddiv_rn(W[j * w2 + k], p);
    for (int i = tid; i < m; i += nt) f[i] = i == j ? 0.0 : W[i * w2 + j];
    __syncthreads();
    for (int idx = tid; idx < n; idx += nt) {
      const int i = idx / w2, k = idx - i * w2;
      W[idx] = i == j ? row[k] : __dsub_rn(W[idx], __dmul_rn(f[i], row[k]));
    }
    __syncthreads();
  }
  double* out = Dinv + lane * m * m;
  for (int idx = tid; idx < m * m; idx += nt) {
    const int i = idx / m, k = idx - i * m;
    out[idx] = W[i * w2 + m + k];
  }
}

}  // namespace

// Returns a cudaError_t code (0 = launched). Launches on `stream`, does not
// synchronise and allocates nothing: the caller owns Dinv (w, m, m), ap and
// piv (w, m). D is (w, m, m) contiguous; delta points to one double on the
// device (read by the kernel, so the host never waits for it).
extern "C" int gj_inv_f64(const double* D, const double* delta, int w, int m,
                          double* Dinv, double* ap, double* piv,
                          void* stream) {
  if (w <= 0) return (int)cudaGetLastError();
  if (m < 1 || m > kMaxM) return (int)cudaErrorInvalidValue;
  int threads = (2 * m * m + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  gj_inv_kernel<<<(unsigned)w, threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(D, delta, m, Dinv, ap,
                                                       piv);
  return (int)cudaGetLastError();
}
