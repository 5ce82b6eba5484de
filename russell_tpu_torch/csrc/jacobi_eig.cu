// The Jacobi eigendecomposition of a symmetric f64 matrix, whole, in one
// launch: ``sweeps`` sweeps of plane rotations in a parallel round-robin
// order, returning diag(A) and V unsorted.
//
// Replaces: russell_tpu/dense/matrix_ops.py, mat_eigen_sym_jacobi (plain
// XLA, no Pallas: a lax.scan of 30 sweeps, each a lax.scan over the
// n (n - 1) / 2 pairs in row-major order). Its plain PyTorch version,
// _jacobi_eig_plain in dense/matrix_ops.py, runs the same rounds as torch
// ops vectorised over a round's pairs.
//
// The order (dense/matrix_ops.py, _jacobi_rounds): m = n rounded up to
// even, h = m / 2 slots; round r = 0 .. m - 2 pairs slot 0 as (r, m - 1)
// and slot k >= 1 as ((r + k) mod (m - 1), (r - k) mod (m - 1)), each as
// p = min, q = max; for odd n, slot 0 holds the phantom index n and is no
// rotation. A sweep visits every pair once, and a round's pairs are
// disjoint, so its rotations commute. A round takes every pair's c and s
// from the round's starting A (the reference's Rutishauser t: theta = 0
// gives t = 1, a_pq = 0 gives t = 0), then A <- J^T A J as independent
// 2 x 2 blocks (the rows of slot I by the columns of slot J: the row stage
// with (c_I, s_I), then the column stage with (c_J, s_J)), and V <- V J
// column pair by column pair. Every product, sum, quotient and square
// root is rounded on its own (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn,
// __dsqrt_rn: no FMA contraction) in the plain version's order, so the
// output equals the plain version's bit for bit.
//
// What bounds it on an H100: 9 n^2 (n - 1) + 6.5 n (n - 1) flops a sweep
// (5e9 in 30 sweeps at n 256: 0.07 ms at 67 TFLOP/s) against n^2 doubles
// in and n^2 + n out: operations, in principle. In fact each round waits
// for the one before: its c and s are a chain of three divisions and two
// square roots on the entries the last round wrote, and its updates need
// all of them. So the time is the rounds, 30 (m - 1) of them, each that
// chain, its barriers (below) and the round's updates spread over the
// threads; the cyclic order it replaces was a chain of n (n - 1) / 2 rotations a
// sweep, two barriers each.
//
// Design: a ring. Index m - 1 stays in slot 0's top seat; the others sit
// on a ring of m - 1 positions (position 0 is slot 0's bottom seat, 1 ..
// h - 1 the top seats 1 .. h - 1, h .. m - 2 the bottom seats h - 1 .. 1)
// and move one position down a round: the index at position x in round R
// is (x + R) mod (m - 1), which is the order above. A launch is a cluster
// of C CTAs (C = 1 in route (a), 16 or 8 in routes (b) and (c), fewer
// when n has fewer slots); CTA c holds slots [c h / C, (c + 1) h / C),
// both seats, and stores the whole rows of A and V^T of
// its seats. Its seats form one arc of the ring (CTA 0 and the last CTA)
// or two (the others), and an arc of len positions keeps its rows in
// len + 1 storage rows used as a circular buffer: the row at arc offset o
// in round R lies in storage row (o + R) mod (len + 1), so a row moving
// along its arc is never copied. Only the row that enters an arc at its
// end moves: in the round it enters, it is read from the storage of the
// arc that held it (a neighbouring CTA's, through distributed shared
// memory), and its updated entries go to the arc's free storage row, which
// no CTA reads in that round. So a CTA reads at most two rows of A and two
// of V^T from other CTAs a round, and the row and column stages work on
// rows it holds. We chose this over keeping every row in place and
// driving the pairs from an index table: there a pair's two rows lie in
// different CTAs most of the time, and about half of a round's reads and
// writes would cross the cluster.
//
// A round: (1) thread k < S of each CTA takes its slot k: where its two
// rows lie and go, and its c and s, written into the (c, s) table of every
// CTA of the cluster; (2) after a CTA barrier, the rows of V^T, which need
// this CTA's (c, s) only, while the cluster's barrier completes
// (barrier.cluster.arrive before them, .wait after); (3) the 2 x 2 blocks
// (local slot, any slot) of A, read where they lie and written where they
// go (in place but for an entering row); the cluster's barrier. Two
// cluster barriers and one CTA barrier a round (route (a): two CTA
// barriers). A round's places (its slots' indices, each arc's storage
// row) advance by counters, not divisions, and a thread takes its items
// two at a time, both loads before either store.
// After the last round each CTA writes w and V from its rows (the one that
// entered an arc last still in its neighbour's storage), and a last
// barrier comes before any CTA exits.
//
// Routes, picked by the wrapper (dense/matrix_ops.py, _jacobi_route) from
// n, its one shared-memory budget, the bytes jacobi_eig_plan gives for each
// launch and what the card schedules: (a) one CTA with the rows in its
// shared memory (n <= 118 on 227 KB); (b) a cluster with the rows in its
// CTAs' shared memory (n <= 450 on 16 CTAs, n <= 325 on 8); (c) the same
// cluster with the rows in global scratch (any n >= 2), which the L2 holds
// to n in the low thousands. The cluster has 16 CTAs where the card
// schedules that non-portable size (cudaFuncAttributeNonPortableCluster-
// SizeAllowed, then cudaOccupancyMaxActiveClusters), else 8, the portable
// size, else fewer; 16 took 21 % less time than 8 at n 256 on an H100
// (jacobi_variants.py). The cluster's size changes no bit of the output. A
// launch the card refuses returns its error; nothing falls back to the
// plain version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;  // above 8: a non-portable cluster size

// c and s of the rotation that zeroes a_pq: the plain version's scalar
// operations in its order (dense/matrix_ops.py, _rotations).
__device__ __forceinline__ void rotation(double apq, double app, double aqq,
                                         double& c, double& s) {
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

// Which CTA holds which slots and storage rows.
struct Ring {
  int n, m, h, C;
  __host__ __device__ Ring(int n_, int C_)
      : n(n_), m(n_ + (n_ & 1)), h((n_ + (n_ & 1)) / 2), C(C_) {}
  __host__ __device__ int lo(int c) const { return c * h / C; }
  __host__ __device__ int slots(int c) const { return lo(c + 1) - lo(c); }
  // storage rows of CTA c: its arcs' rows (len + 1 each) and, in CTA 0,
  // the fixed row of index m - 1 after them
  __host__ __device__ int rows(int c) const {
    return 2 * slots(c) + (c == 0 || c == C - 1 ? 1 : 2);
  }
  __host__ int max_rows() const {
    int r = 0;
    for (int c = 0; c < C; ++c) r = rows(c) > r ? rows(c) : r;
    return r;
  }
  __host__ __device__ int max_slots() const {
    int s = 0;
    for (int c = 0; c < C; ++c) s = slots(c) > s ? slots(c) : s;
    return s;
  }
};

struct Arc {
  int cta, base, len;  // its first storage row; its positions
};

// CTA 0's seats are one arc (around position 0), the last CTA's one
// (around position h), another CTA's two: its top seats, then its bottom
// seats from row S + 1.
__device__ __forceinline__ Arc arc_of(const Ring& g, int c, int which) {
  const int S = g.slots(c);
  if (c == 0) return {0, 0, 2 * S - 1};
  if (c == g.C - 1) return {c, 0, 2 * S};
  return which == 0 ? Arc{c, 0, S} : Arc{c, S + 1, S};
}

// the arc whose first position follows this arc's last: the rows enter
// from there
__device__ __forceinline__ Arc next_arc(const Ring& g, int c, int which) {
  if (c == 0) return arc_of(g, g.C == 1 ? 0 : 1, 0);
  if (c == g.C - 1 || which == 1) return arc_of(g, c - 1, c == 1 ? 0 : 1);
  return arc_of(g, c + 1, 0);
}

// A local slot's rows in one round, as pointers to their rows of A (V^T's
// row of the same storage row lies vt doubles further on).
struct Slot {
  double* p_src;  // where row p lies at the round's start
  double* q_src;
  double* p_dst;  // where its updated entries go
  double* q_dst;
  int p, q;       // q == n: slot 0's phantom (odd n), no rotation
};

// Where this CTA's seats keep their rows, and the round's place on the
// ring and in each circular buffer, advanced a round at a time without a
// division.
struct Seats {
  int n, m, ring, C, c, lo, hi;
  Arc own[2], next[2];    // this CTA's arcs, and those their rows enter from
  double* region;         // this CTA's first row of A
  double* next_region[2];
  double* fixed;          // CTA 0: the row of index m - 1
  int r;                  // R mod (m - 1)
  int rm[2];              // R mod (own[w].len + 1)
  int nm[2];              // (R - 1) mod (next[w].len + 1)
  bool entered;           // R > 0: a row enters each arc

  __device__ __forceinline__ void advance() {
    r = r + 1 == ring ? 0 : r + 1;
    for (int w = 0; w < 2; ++w) {
      rm[w] = rm[w] == own[w].len ? 0 : rm[w] + 1;
      nm[w] = nm[w] == next[w].len ? 0 : nm[w] + 1;
    }
    entered = true;
  }

  // index of the row at seat (J, top) this round, where it lies (src) and
  // where it goes (dst); slot 0's top seat holds the fixed row
  __device__ __forceinline__ int row(int J, bool top, double*& src,
                                     double*& dst) const {
    if (top && J == 0) {
      src = dst = fixed;
      return m - 1;
    }
    int which, off;
    if (c == 0) {
      which = 0;
      off = top ? hi - 1 + J : hi - 1 - J;
    } else if (c == C - 1) {
      which = 0;
      off = top ? J - lo : 2 * hi - lo - 1 - J;
    } else {
      which = top ? 0 : 1;
      off = top ? J - lo : hi - 1 - J;
    }
    const Arc a = which ? own[1] : own[0];
    int s = off + (which ? rm[1] : rm[0]);
    if (s > a.len) s -= a.len + 1;
    dst = region + static_cast<long long>(a.base + s) * n;
    src = dst;
    if (entered && off == a.len - 1) {
      const Arc b = which ? next[1] : next[0];
      src = (which ? next_region[1] : next_region[0]) +
            static_cast<long long>(b.base + (which ? nm[1] : nm[0])) * n;
    }
    if (top) return r + J >= ring ? r + J - ring : r + J;
    return r >= J ? r - J : r - J + ring;
  }
};

// the items (k, j), j < w, that a thread takes: item e = threadIdx.x +
// i blockDim.x is (e / w, e mod w), stepped without a division
struct Items {
  int k, j, dk, dj, w;
  __device__ __forceinline__ Items(int w_) : w(w_) {
    k = threadIdx.x / w;
    j = threadIdx.x - k * w;
    dk = blockDim.x / w;
    dj = blockDim.x - dk * w;
  }
  __device__ __forceinline__ void step(int& kk, int& jj) const {
    kk += dk;
    jj += dj;
    if (jj >= w) {
      jj -= w;
      ++kk;
    }
  }
};

template <bool kCluster>
__device__ __forceinline__ void barrier() {
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// the column indices (p, q) of slot J in round r, q == n for the phantom
__device__ __forceinline__ void slot_columns(int J, int r, int m, int ring,
                                             int& pj, int& qj) {
  const int xt = J == 0 ? m - 1 : (r + J >= ring ? r + J - ring : r + J);
  const int xb = r >= J ? r - J : r - J + ring;
  pj = xt < xb ? xt : xb;
  qj = xt < xb ? xb : xt;
}

// The 2 x 2 block (rows of slot sl, columns pj, qj): the row stage with
// (ci, si), then the column stage with (cj, sj). Loads in one call and
// stores in another, so that two blocks' loads can be in flight at once.
struct Block {
  double a, b, cq, d;
  __device__ __forceinline__ void load(const Slot& sl, int n, int pj,
                                       int qj) {
    const bool row2 = sl.q < n, col2 = qj < n;
    a = sl.p_src[pj];
    b = col2 ? sl.p_src[qj] : 0.0;
    cq = row2 ? sl.q_src[pj] : 0.0;
    d = row2 && col2 ? sl.q_src[qj] : 0.0;
  }
  __device__ __forceinline__ void rotate_store(const Slot& sl, int n, int pj,
                                               int qj, const double2* cs,
                                               int I, int J) {
    const bool row2 = sl.q < n, col2 = qj < n;
    if (row2) {
      const double ci = cs[I].x, si = cs[I].y;
      const double rpp = rot_minus(a, cq, ci, si);
      const double rpq = rot_minus(b, d, ci, si);
      const double rqp = rot_plus(a, cq, ci, si);
      const double rqq = rot_plus(b, d, ci, si);
      a = rpp;
      b = rpq;
      cq = rqp;
      d = rqq;
    }
    if (col2) {
      const double cj = cs[J].x, sj = cs[J].y;
      const double npp = rot_minus(a, b, cj, sj);
      const double npq = rot_plus(a, b, cj, sj);
      const double nqp = rot_minus(cq, d, cj, sj);
      const double nqq = rot_plus(cq, d, cj, sj);
      a = npp;
      b = npq;
      cq = nqp;
      d = nqq;
    }
    sl.p_dst[pj] = a;
    if (col2) sl.p_dst[qj] = b;
    if (row2) sl.q_dst[pj] = cq;
    if (row2 && col2) sl.q_dst[qj] = d;
  }
};

// V^T's entries j of slot sl's rows p and q: (p, q) <- (p c - q s, p s + q c)
__device__ __forceinline__ void rotate_vt(const Slot& sl, int n,
                                          long long vt, int j, double vp,
                                          double vq, const double2* cs,
                                          int I) {
  if (sl.q < n) {
    const double ci = cs[I].x, si = cs[I].y;
    sl.p_dst[vt + j] = rot_minus(vp, vq, ci, si);
    sl.q_dst[vt + j] = rot_plus(vp, vq, ci, si);
  } else {
    sl.p_dst[vt + j] = vp;
  }
}

template <bool kShared, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads, 1)
    jacobi_eig_kernel(const double* __restrict__ a_in, int n, int sweeps,
                      int rows, double* work, double* __restrict__ w_out,
                      double* __restrict__ v_out) {
  extern __shared__ __align__(16) double smem[];
  const Ring g(n, static_cast<int>(gridDim.x));
  const int c = blockIdx.x;  // the grid is one cluster: the CTA's rank
  const long long vt = static_cast<long long>(rows) * n;
  // (c, s) of slot J
  double2* const cs = reinterpret_cast<double2*>(kShared ? smem + 2 * vt
                                                         : smem);
  Slot* const slot = reinterpret_cast<Slot*>(cs + g.h);
  const int lo = g.lo(c), S = g.slots(c), h = g.h, ring = g.m - 1;
  const int total = sweeps * ring;

  // the first row of A of CTA d
  auto region = [&](int d) -> double* {
    if constexpr (!kShared) {
      return work + 2 * vt * d;
    } else if constexpr (kCluster) {
      return d == c ? smem : cg::this_cluster().map_shared_rank(smem, d);
    } else {
      return smem;
    }
  };
  // the seats' state lives in shared memory, read by the threads that set
  // up the round's slots and advanced by thread 0: registers stay free
  Seats* const seats = reinterpret_cast<Seats*>(slot + g.max_slots());
  if (threadIdx.x == 0) {
    Seats st;
    st.n = n;
    st.m = g.m;
    st.ring = ring;
    st.C = g.C;
    st.c = c;
    st.lo = lo;
    st.hi = lo + S;
    st.region = region(c);
    st.fixed = region(0) + static_cast<long long>(2 * g.slots(0)) * n;
    for (int w = 0; w < 2; ++w) {
      st.own[w] = arc_of(g, c, w);
      st.next[w] = next_arc(g, c, w);
      st.next_region[w] = region(st.next[w].cta);
      st.rm[w] = 0;
      st.nm[w] = st.next[w].len;  // (-1) mod (len + 1)
    }
    st.r = 0;
    st.entered = false;
    *seats = st;
  }
  __syncthreads();
  const Seats& st = *seats;
  int r = 0;  // R mod (m - 1), in every thread

  // the rows of round 0 (where no row enters an arc): row x of A, e_x
  const Items ia(h), iv(n);  // (seat or slot, column) items
  for (int u = iv.k, j = iv.j; u < 2 * S; iv.step(u, j)) {
    double *src, *dst;
    const int x = st.row(lo + (u < S ? u : u - S), u < S, src, dst);
    if (x >= n) continue;
    dst[j] = a_in[static_cast<long long>(x) * n + j];
    dst[vt + j] = x == j ? 1.0 : 0.0;
  }
  barrier<kCluster>();

  for (int R = 0; R < total; ++R, r = r + 1 == ring ? 0 : r + 1) {
    // (1) this CTA's slots: rows and (c, s), the latter to every CTA
    for (int k = threadIdx.x; k < S; k += blockDim.x) {
      const int J = lo + k;
      double *ts, *td, *bs, *bd;
      const int xt = st.row(J, true, ts, td);
      const int xb = st.row(J, false, bs, bd);
      const Slot sl = xt < xb ? Slot{ts, bs, td, bd, xt, xb}
                              : Slot{bs, ts, bd, td, xb, xt};
      slot[k] = sl;
      if (sl.q < n) {
        double cc, ss;
        rotation(sl.p_src[sl.q], sl.p_src[sl.p], sl.q_src[sl.q], cc, ss);
        for (int d = 0; d < g.C; ++d) {
          double2* t = cs;
          if constexpr (kCluster) {
            if (d != c) t = cg::this_cluster().map_shared_rank(cs, d);
          }
          t[J] = make_double2(cc, ss);
        }
      }
    }
    // this CTA's (c, s) are in place: V^T's rows need no other, so they go
    // while the cluster's barrier completes
    if constexpr (kCluster) {
      asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
    }
    __syncthreads();
    for (int k = iv.k, j = iv.j; k < S;) {
      int k2 = k, j2 = j;
      iv.step(k2, j2);
      const Slot s1 = slot[k];
      const double p1 = s1.p_src[vt + j];
      const double q1 = s1.q < n ? s1.q_src[vt + j] : 0.0;
      if (k2 < S) {
        const Slot s2 = slot[k2];
        const double p2 = s2.p_src[vt + j2];
        const double q2 = s2.q < n ? s2.q_src[vt + j2] : 0.0;
        rotate_vt(s1, n, vt, j, p1, q1, cs, lo + k);
        rotate_vt(s2, n, vt, j2, p2, q2, cs, lo + k2);
        iv.step(k2, j2);
      } else {
        rotate_vt(s1, n, vt, j, p1, q1, cs, lo + k);
      }
      k = k2;
      j = j2;
    }
    if constexpr (kCluster) {
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    }
    // (2) the blocks (local slot k, slot J) of A, two at a time
    for (int k = ia.k, J = ia.j; k < S;) {
      int k2 = k, J2 = J;
      ia.step(k2, J2);
      int p1, q1;
      slot_columns(J, r, g.m, ring, p1, q1);
      const Slot s1 = slot[k];
      Block b1;
      b1.load(s1, n, p1, q1);
      if (k2 < S) {
        int p2, q2;
        slot_columns(J2, r, g.m, ring, p2, q2);
        const Slot s2 = slot[k2];
        Block b2;
        b2.load(s2, n, p2, q2);
        b1.rotate_store(s1, n, p1, q1, cs, lo + k, J);
        b2.rotate_store(s2, n, p2, q2, cs, lo + k2, J2);
        ia.step(k2, J2);
      } else {
        b1.rotate_store(s1, n, p1, q1, cs, lo + k, J);
      }
      k = k2;
      J = J2;
    }
    if (threadIdx.x == 0) seats->advance();  // read again after the barrier
    barrier<kCluster>();
  }

  // w and V: each row where the last round left it (for the row that
  // entered an arc last, the storage it came from: another CTA's)
  for (int u = iv.k, j = iv.j; u < 2 * S; iv.step(u, j)) {
    double *src, *dst;
    const int x = st.row(lo + (u < S ? u : u - S), u < S, src, dst);
    if (x >= n) continue;
    v_out[static_cast<long long>(j) * n + x] = src[vt + j];
    if (j == x) w_out[x] = src[x];
  }
  // no CTA leaves while another may still read its rows
  barrier<kCluster>();
}

using Kernel = void (*)(const double*, int, int, int, double*, double*,
                        double*);

// A launch's sizes on C CTAs, the rows in shared memory or global scratch.
// The storage layout lives here alone: the wrapper asks jacobi_eig_plan.
struct Plan {
  int rows;        // storage rows of the largest CTA
  int threads;     // a CTA
  size_t smem;     // dynamic shared memory a CTA
  long long work;  // doubles of global scratch (route (c)), else 0
  Kernel kernel;
};

// false where (n, cluster) is no launch: n < 2, or a cluster that is not a
// power of two at most kMaxCluster and the h slots
bool plan_of(int n, int cluster, bool shared, Plan& p) {
  if (n < 2 || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0)
    return false;
  const Ring g(n, cluster);
  if (cluster > g.h) return false;
  p.rows = g.max_rows();
  const long long stored = 2LL * p.rows * n;  // doubles of A and V^T a CTA
  p.smem = 16 * static_cast<size_t>(g.h) +
           sizeof(Slot) * static_cast<size_t>(g.max_slots()) + sizeof(Seats) +
           (shared ? 8 * static_cast<size_t>(stored) : 0);
  p.work = shared ? 0 : cluster * stored;
  const long long items = static_cast<long long>(g.max_slots()) * n;
  p.threads = items >= kMaxThreads ? kMaxThreads
                                   : static_cast<int>((items + 31) / 32 * 32);
  p.kernel = shared ? (cluster > 1 ? jacobi_eig_kernel<true, true>
                                   : jacobi_eig_kernel<true, false>)
                    : (cluster > 1 ? jacobi_eig_kernel<false, true>
                                   : jacobi_eig_kernel<false, false>);
  return true;
}

// Sets p's kernel attributes and fills cfg (attr: its cluster dimension);
// active = how many such clusters the card runs at once
// (cudaOccupancyMaxActiveClusters), or on one CTA how many such CTAs an SM
// holds: 0 where it schedules none.
cudaError_t configure(const Plan& p, int cluster, cudaStream_t stream,
                      cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                      int& active) {
  cudaError_t err = cudaFuncSetAttribute(
      p.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  if (cluster == 1)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&active, p.kernel,
                                                         p.threads, p.smem);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        p.kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveClusters(&active, p.kernel, &cfg);
}

}  // namespace

// The sizes of a launch at n on cluster CTAs (1, 2, 4, 8 or 16; at most
// the h slots) with the rows of A and V^T in the CTAs' shared memory
// (shared_route 1) or in global scratch (0): smem_bytes of dynamic shared
// memory a CTA and work_doubles of scratch. Where active is not null, also
// how many such launches the card holds at once (0: it schedules none).
extern "C" int jacobi_eig_plan(int n, int cluster, int shared_route,
                               long long* smem_bytes, long long* work_doubles,
                               int* active) {
  Plan p;
  if (!plan_of(n, cluster, shared_route != 0, p))
    return static_cast<int>(cudaErrorInvalidValue);
  *smem_bytes = static_cast<long long>(p.smem);
  *work_doubles = p.work;
  if (active == nullptr) return static_cast<int>(cudaSuccess);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  return static_cast<int>(configure(p, cluster, nullptr, cfg, attr, *active));
}

// a (n x n, row-major, read only), sweeps, cluster and shared_route as in
// jacobi_eig_plan, work (work_doubles, at least the plan's; null in the
// shared route), w (n) = diag(A) and v (n x n) = V, unsorted. A launch the
// card cannot schedule returns cudaErrorLaunchOutOfResources.
extern "C" int jacobi_eig_f64(const double* a, int n, int sweeps,
                              int cluster, int shared_route, double* work,
                              long long work_doubles, double* w, double* v,
                              cudaStream_t stream) {
  Plan p;
  if (sweeps < 0 || !plan_of(n, cluster, shared_route != 0, p) ||
      (!shared_route && (work == nullptr || work_doubles < p.work)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  cudaError_t err = configure(p, cluster, stream, cfg, attr, active);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  err = cudaLaunchKernelEx(&cfg, p.kernel, a, n, sweeps, p.rows, work, w, v);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
