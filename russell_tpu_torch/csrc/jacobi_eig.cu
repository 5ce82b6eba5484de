// The cyclic Jacobi eigendecomposition of a symmetric f64 matrix, whole,
// in one CTA: ``sweeps`` sweeps of plane rotations over the pairs (p, q)
// in row-major upper-triangle order, returning diag(A) and V unsorted.
//
// Replaces: russell_tpu/dense/matrix_ops.py, mat_eigen_sym_jacobi (plain
// XLA, no Pallas: a lax.scan of 30 sweeps, each a lax.scan over the
// n (n - 1) / 2 pairs). Its plain PyTorch version, _jacobi_eig_plain in
// dense/matrix_ops.py, costs about 40 launches a rotation: 2.4 million
// launches at n 64.
//
// Each rotation takes the reference's Rutishauser t (theta = 0, an equal
// diagonal, gives t = 1; a_pq = 0 gives t = 0), then updates rows p, q of
// A, then its columns p, q, then columns p, q of V. Every product, sum,
// quotient and square root is rounded on its own (__dmul_rn, __dadd_rn,
// __dsub_rn, __ddiv_rn, __dsqrt_rn: no FMA contraction) in the plain
// version's order, so the output equals the plain version's bit for bit.
// Rows then columns is one pass here: for j outside {p, q}, row entries
// (p, j), (q, j) and column entries (j, p), (j, q) depend only on
// themselves and are updated by thread j; the 2 x 2 block (p, q) x (p, q)
// takes the row stage then the column stage in the thread of j = p. V is
// kept transposed, so its columns p, q are rows, like A's.
//
// What bounds it on an H100: per rotation about 18 n flops, in all
// sweeps n^2 (n - 1) / 2 x 18 (5e9 at n 256, 0.07 ms at 67 TFLOP/s),
// while n^2 doubles in and n^2 + n out take microseconds: operations, in
// principle. In fact the rotations are a dependent chain: each needs the
// entries the last one wrote, and its c and s are a chain of three
// divisions and two square roots before any update; a rotation costs two
// barriers (all threads have read a_pp, a_qq, a_pq; all updates are
// written), 2 x sweeps x n (n - 1) / 2 in all. The chain, not the bound,
// sets the time.
//
// Design: one CTA, a thread per index j (strided when n > 1024). A and
// V^T live in shared memory, rows padded to n + 1 doubles so that a
// column's entries fall in different banks, while 2 n (n + 1) doubles fit
// the budget the wrapper checks (dense/matrix_ops.py, JACOBI_SMEM_BYTES:
// n <= 119 on the H100's 227 KB); above it the same kernel works in two
// n x n scratch matrices in global memory, which the L2 holds at these
// sizes. Any n >= 2 is taken.

#include <cuda_runtime.h>

#include <cmath>

namespace {

// c and s of the rotation that zeroes a_pq: the plain version's scalar
// operations in its order.
__device__ __forceinline__ void rotation(const double* A, int ld, int p,
                                         int q, double& c, double& s) {
  const double apq = A[p * ld + q];
  const double app = A[p * ld + p];
  const double aqq = A[q * ld + q];
  const bool vanishes = apq == 0.0;
  const double theta = __ddiv_rn(__dsub_rn(aqq, app),
                                 __dmul_rn(2.0, vanishes ? 1.0 : apq));
  const double sgn = theta >= 0.0 ? 1.0 : -1.0;
  double t = __ddiv_rn(
      sgn, __dadd_rn(fabs(theta),
                     __dsqrt_rn(__dadd_rn(1.0, __dmul_rn(theta, theta)))));
  if (vanishes) t = 0.0;
  c = __ddiv_rn(1.0, __dsqrt_rn(__dadd_rn(1.0, __dmul_rn(t, t))));
  s = __dmul_rn(t, c);
}

// x c - y s and x s + y c, each product and sum rounded apart
__device__ __forceinline__ double rot_minus(double x, double y, double c,
                                            double s) {
  return __dsub_rn(__dmul_rn(x, c), __dmul_rn(y, s));
}

__device__ __forceinline__ double rot_plus(double x, double y, double c,
                                           double s) {
  return __dadd_rn(__dmul_rn(x, s), __dmul_rn(y, c));
}

template <bool kShared>
__global__ void jacobi_eig_kernel(const double* __restrict__ a_in, int n,
                                  int sweeps, double* work_a,
                                  double* work_vt, double* __restrict__ w_out,
                                  double* __restrict__ v_out) {
  extern __shared__ double smem[];
  const int ld = kShared ? n + 1 : n;
  double* A = kShared ? smem : work_a;
  double* VT = kShared ? smem + static_cast<size_t>(n) * ld : work_vt;
  const int nn = n * n;
  for (int k = threadIdx.x; k < nn; k += blockDim.x) {
    const int i = k / n, j = k - (k / n) * n;
    A[i * ld + j] = a_in[k];
    VT[i * ld + j] = i == j ? 1.0 : 0.0;
  }
  __syncthreads();
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        double c, s;
        rotation(A, ld, p, q, c, s);
        __syncthreads();  // every thread has read a_pp, a_qq and a_pq
        for (int j = threadIdx.x; j < n; j += blockDim.x) {
          if (j == p) {
            const double pp = A[p * ld + p], pq = A[p * ld + q];
            const double qp = A[q * ld + p], qq = A[q * ld + q];
            // rows p, q, then columns p, q
            const double rpp = rot_minus(pp, qp, c, s);
            const double rpq = rot_minus(pq, qq, c, s);
            const double rqp = rot_plus(pp, qp, c, s);
            const double rqq = rot_plus(pq, qq, c, s);
            A[p * ld + p] = rot_minus(rpp, rpq, c, s);
            A[p * ld + q] = rot_plus(rpp, rpq, c, s);
            A[q * ld + p] = rot_minus(rqp, rqq, c, s);
            A[q * ld + q] = rot_plus(rqp, rqq, c, s);
          } else if (j != q) {
            const double apj = A[p * ld + j], aqj = A[q * ld + j];
            A[p * ld + j] = rot_minus(apj, aqj, c, s);
            A[q * ld + j] = rot_plus(apj, aqj, c, s);
            const double ajp = A[j * ld + p], ajq = A[j * ld + q];
            A[j * ld + p] = rot_minus(ajp, ajq, c, s);
            A[j * ld + q] = rot_plus(ajp, ajq, c, s);
          }
          const double vpj = VT[p * ld + j], vqj = VT[q * ld + j];
          VT[p * ld + j] = rot_minus(vpj, vqj, c, s);
          VT[q * ld + j] = rot_plus(vpj, vqj, c, s);
        }
        __syncthreads();  // the rotation is written
      }
    }
  }
  for (int k = threadIdx.x; k < nn; k += blockDim.x) {
    const int i = k / n, j = k - (k / n) * n;
    v_out[k] = VT[j * ld + i];
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) w_out[j] = A[j * ld + j];
}

}  // namespace

// a (n x n, row-major, read only), sweeps, shared_route (1: A and V^T in
// 2 n (n + 1) doubles of shared memory; 0: in work_a and work_vt, n x n
// each, global), w (n) = diag(A) and v (n x n) = V, unsorted.
extern "C" int jacobi_eig_f64(const double* a, int n, int sweeps,
                              int shared_route, double* work_a,
                              double* work_vt, double* w, double* v,
                              cudaStream_t stream) {
  if (n < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = n >= 1024 ? 1024 : ((n + 31) / 32) * 32;
  if (shared_route) {
    const size_t bytes = 2 * sizeof(double) * static_cast<size_t>(n) *
                         static_cast<size_t>(n + 1);
    cudaError_t err = cudaFuncSetAttribute(
        jacobi_eig_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    jacobi_eig_kernel<true><<<1, threads, bytes, stream>>>(
        a, n, sweeps, nullptr, nullptr, w, v);
  } else {
    if (work_a == nullptr || work_vt == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    jacobi_eig_kernel<false><<<1, threads, 0, stream>>>(
        a, n, sweeps, work_a, work_vt, w, v);
  }
  return static_cast<int>(cudaGetLastError());
}
