// Batched Gauss-Jordan inverse with static pivot clamping, f64, and the
// per-lane pivot statistics: the base case (m <= 144; splu.GJ_MAX_M) of
// the pivot-block inverse of both sparse solvers.
//
// Replaces: russell_tpu/sparse/splu.py, _gj_inv (plain XLA, no Pallas: m
// unrolled elimination steps of elementwise ops over the batch), which
// splu._inv_block reaches at the bottom of its 2x2 Schur recursion for
// every SPLU diagonal lane and every GRIDMF pivot block.
//
// Per lane (no row interchanges), step j takes the pivot p = W[j][j],
// replaces it when |p| <= delta by delta * p / |p| (delta when p is 0:
// MUMPS-style static pivot clamping), then row = W[j] / p, W -= f (x) row
// with f the pivot column (f[j] = 0), W[j] = row. The plain version does
// this on [D | I] and returns the right half; here it runs in place on the
// m x m block: once step j is done, column j holds the inverse's column j
// (1/p on the diagonal, 0 - f * (1/p) off it), which is the right half's
// column j computed by the same operations, so Dinv has the plain
// version's values. Each product and difference is rounded apart
// (__dmul_rn, __dsub_rn, __ddiv_rn: no FMA contraction), in the plain
// version's order, which is how torch computes it elementwise. The four
// statistics follow the reference (russell_tpu/sparse/splu.py:497-509):
// ld += log(max(|p_clamped|, 1e-300)), mp = min(mp, |p|), npert += |p| <=
// delta, ph *= sign(p_clamped), summed in step order after the elimination
// from the pivots it recorded, so that no log sits on a step's path.
//
// What bounds it on an H100: per lane m^2 doubles in, m^2 out and 2 m^3
// flops (m steps of an m x m rank-1 update): 32 flops a byte at m 128,
// above the f64 ridge (~20), so operations bound it in principle; in fact
// the m dependent steps do. A step is a chain of a barrier, a shared load
// of the pivot, the clamp test and a division (about ten dependent f64
// operations) before its update can start, and the publication of the
// next pivot row and column after it; rounding the product and the
// difference apart costs two f64 instructions an entry where an FMA would
// take one.
//
// Design: a CTA per lane, the block in registers. Thread (s, k) of S =
// ceil(m / R) slices (1 to 4) holds R consecutive rows of column k, so the
// whole block lives in the CTA's registers (144^2 doubles are 162 KB of
// the SM's 256 KB register file) and an entry's update reads no operand
// from shared memory but the pivot column, broadcast, two entries a load.
// The threads that own row j + 1 and column j + 1 publish them to a
// double-buffered shared row and column right after their update, so
// every step costs one barrier; each thread clamps the pivot itself. No
// step tests its rows one by one: rows past m are rows no one reads,
// updated like the others and never stored, and the pivot row and column
// take their new values from the update itself (see publish). A warp per
// lane (a column a thread, the pivot column by __shfl_sync, the steps
// unrolled) ran slower at m <= 32 (PERF.md).

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxM = 144;      // splu.GJ_MAX_M is at most this

// The clamped pivot of one step.
__device__ __forceinline__ double clamp_pivot(double pj, double d) {
  const double ap = fabs(pj);
  if (ap <= d) {
    const double unit = ap > 0.0 ? __ddiv_rn(pj, fmax(ap, 1e-300)) : 1.0;
    return __dmul_rn(unit, d);
  }
  return pj;
}

// x / p, rounded as __ddiv_rn rounds it. A zero x (frequent in the
// plans' blocks) sends __ddiv_rn down its slow path, so it takes the
// product instead: 0 * p is 0 / p, sign included, for a finite p != 0.
__device__ __forceinline__ double quotient(double x, double p) {
  return x == 0.0 && isfinite(p) && p != 0.0 ? __dmul_rn(x, p)
                                             : __ddiv_rn(x, p);
}

// The statistics, one step at a time in step order: ``p`` the clamped
// pivot, ``ap`` |pivot| before the clamp.
struct Stats {
  double ld = 0.0, mp = INFINITY, ph = 1.0;
  int np = 0;

  __device__ __forceinline__ void add(double p, double ap, double d) {
    mp = (ap < mp || isnan(ap)) ? ap : mp;   // NaN stays, as in torch
    np += ap <= d;
    const double apj = fabs(p);
    ph = __dmul_rn(ph, apj > 0.0 ? __ddiv_rn(p, fmax(apj, 1e-300)) : 1.0);
    ld = __dadd_rn(ld, log(fmax(apj, 1e-300)));
  }

  __device__ __forceinline__ void store(long long lane, double* ld_out,
                                        double* mp_out, int* np_out,
                                        double* ph_out) const {
    ld_out[lane] = ld;
    mp_out[lane] = mp;
    np_out[lane] = np;
    ph_out[lane] = ph;
  }
};

// Step jn's pivot row and pivot column, published by their owners into the
// shared buffers prow and pcol (this thread's slice starts at pcol[i0]) at
// the end of step jn - 1. The slice that holds row jn (qn = jn - i0 in
// [0, R)) keeps its registers rotated so that the row is in W[0]: it
// rotates them by one for each of its rows after the first, and pcol[i0 +
// q] follows the slice's register q. Two exact tricks keep the update one
// product and one difference an entry, with no test: the registers of the
// pivot row and of the pivot column are zeroed once published, and the
// pivot row's entry of the published column is -1, so the update leaves
// 0 - f * (1/p) in the pivot column and 0 - (-1) * r = r in the pivot row.
template <int R>
__device__ __forceinline__ void publish(double (&W)[R], int jn, int qn,
                                        int k, int m, double* prow,
                                        double* pcol, int i0) {
  const bool mine = jn < m && qn >= 0 && qn < R;
  if (mine) {
    if (qn > 0) {
      const double w0 = W[0];
#pragma unroll
      for (int q = 0; q + 1 < R; ++q) W[q] = W[q + 1];
      W[R - 1] = w0;
    }
    prow[k] = W[0];
    W[0] = 0.0;
  }
  if (k == jn) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      pcol[i0 + q] = W[q];
      W[q] = 0.0;
    }
    if (mine) pcol[i0] = -1.0;
  }
}

// A CTA per lane of T = S * m threads at most; thread (s, k) holds rows
// s * R ... s * R + R - 1 of column k in registers, in the order publish
// leaves them (those at or past m are never stored).
template <int R, int T>
__global__ void __launch_bounds__(T)
    gj_inv_cta(const double* __restrict__ D, long long sb, long long sr,
               const double* __restrict__ delta, int per_delta, int m,
               double* __restrict__ Dinv, double* __restrict__ ld,
               double* __restrict__ mp, int* __restrict__ np,
               double* __restrict__ ph) {
  static_assert(R % 2 == 0, "R even: the pivot column is read in pairs");
  __shared__ __align__(16) double prow[2][kMaxM];  // row j before step j
  __shared__ __align__(16) double pcol[2][kMaxM];  // column j before step j
  __shared__ double piv[kMaxM], apiv[kMaxM];  // step j's pivot, |pivot|
  __shared__ double s_delta;
  const long long lane = blockIdx.x;
  const int s = threadIdx.x / m;
  const int k = threadIdx.x - s * m;
  const int i0 = s * R;
  const int n = m - i0;              // rows q < n are rows of the block
  const double* Dl = D + lane * sb + i0 * sr + k;
  double W[R];
#pragma unroll
  for (int q = 0; q < R; ++q) W[q] = q < n ? Dl[q * sr] : 0.0;
  if (threadIdx.x == 0) s_delta = delta[lane / per_delta];
  publish(W, 0, -i0, k, m, prow[0], pcol[0], i0);
  for (int j = 0; j < m; ++j) {
    const int b = j & 1;
    __syncthreads();
    const double d = s_delta;
    const double pj = prow[b][j];
    const double p = clamp_pivot(pj, d);
    if (threadIdx.x == 0) {
      piv[j] = p;
      apiv[j] = fabs(pj);
    }
    const double r = quotient(k == j ? 1.0 : prow[b][k], p);
    const double2* f = reinterpret_cast<const double2*>(pcol[b] + i0);
#pragma unroll
    for (int q = 0; q < R; q += 2) {
      const double2 fq = f[q / 2];
      W[q] = __dsub_rn(W[q], __dmul_rn(fq.x, r));
      W[q + 1] = __dsub_rn(W[q + 1], __dmul_rn(fq.y, r));
    }
    publish(W, j + 1, j + 1 - i0, k, m, prow[b ^ 1], pcol[b ^ 1], i0);
  }
  // the slice rotated its registers once for each of its rows but the
  // first: register q holds its row (q + rot) mod R
  const int rot = min(n, R) - 1;
  double* out = Dinv + lane * m * m + i0 * m + k;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int row = q + rot < R ? q + rot : q + rot - R;
    if (row < n) out[row * m] = W[q];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Stats st;
    for (int j = 0; j < m; ++j) st.add(piv[j], apiv[j], s_delta);
    st.store(lane, ld, mp, np, ph);
  }
}

template <int R, int T>
void launch(const double* D, long long sb, long long sr, const double* delta,
            int per_delta, int w, int m, double* Dinv, double* ld, double* mp,
            int* np, double* ph, cudaStream_t stream) {
  const int S = (m + R - 1) / R;  // slices of R rows
  gj_inv_cta<R, T><<<(unsigned)w, S * m, 0, stream>>>(
      D, sb, sr, delta, per_delta, m, Dinv, ld, mp, np, ph);
}

}  // namespace

// Returns a cudaError_t code (0 = launched). Launches on `stream`, does not
// synchronise and allocates nothing: the caller owns Dinv (w, m, m)
// contiguous and the per-lane ld, mp, ph (f64) and np (int32), each (w,).
// Lane l's block is D[l * sb + i * sr + c] (row i, column c: the last
// dimension contiguous, so a view into a larger block needs no copy);
// delta points to n_delta doubles on the device (read by the kernel, so the
// host never waits for them), one pivot threshold per run of w / n_delta
// consecutive lanes: lane l reads delta[l / (w / n_delta)]. A batch of B
// matrices' pivot blocks, B runs of w / B lanes, is one launch.
extern "C" int gj_inv_f64(const double* D, long long sb, long long sr,
                          const double* delta, int n_delta, int w, int m,
                          double* Dinv, double* ld, double* mp, int* np,
                          double* ph, void* stream) {
  if (w <= 0) return (int)cudaGetLastError();
  if (m < 1 || m > kMaxM || n_delta < 1 || w % n_delta)
    return (int)cudaErrorInvalidValue;
  const int per = w / n_delta;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // rows a thread holds, R, and the most threads a CTA of that R has, T
  // = ceil(m / R) * m for the band's largest m: 1 to 4 slices
  if (m <= 16) {
    launch<8, 32>(D, sb, sr, delta, per, w, m, Dinv, ld, mp, np, ph, st);
  } else if (m <= 48) {
    launch<12, 192>(D, sb, sr, delta, per, w, m, Dinv, ld, mp, np, ph, st);
  } else if (m <= 64) {
    launch<16, 256>(D, sb, sr, delta, per, w, m, Dinv, ld, mp, np, ph, st);
  } else if (m <= 96) {
    launch<24, 384>(D, sb, sr, delta, per, w, m, Dinv, ld, mp, np, ph, st);
  } else if (m <= 128) {
    launch<32, 512>(D, sb, sr, delta, per, w, m, Dinv, ld, mp, np, ph, st);
  } else if (m <= 138) {
    launch<46, 414>(D, sb, sr, delta, per, w, m, Dinv, ld, mp, np, ph, st);
  } else {
    launch<48, 432>(D, sb, sr, delta, per, w, m, Dinv, ld, mp, np, ph, st);
  }
  return (int)cudaGetLastError();
}

