// Segment-summed block-pair products of one SPLU factorize row, f64, on
// Hopper's f64 tensor cores.
//
// Replaces: russell_tpu/sparse/splu.py, _pairs_pallas (the Pallas TPU
// kernel, one sequential grid step per pair, which zeroes an output block
// at its segment's first pair and accumulates into it).
//
// Computes, for every live lane s < n_live,
//     out[s] = sum over the pairs p of lane s of B[pair_l[p]] @ B[pair_u[p]]
// where B = blocks viewed as (N, BE, BE) row-major f64 tiles. BE is the
// plan's block size: 32 by default for real matrices and 64 for complex
// ones (stored as the real embedding K = [[R,-I],[I,R]]); a plan made with
// block_size 16 gives 16 (real) and 32. Only the n_live lanes are written:
// the plan puts no
// pair on a lane at or past the row's len (checked on the host), so the
// TPU kernel's lanes past len are zeros that nobody reads.
//
// Work list: the host cuts each live lane's pairs into chunks of at most
// K consecutive pairs (splu.py, _pair_chunks; a lane without pairs gets one
// empty chunk) and orders the lanes by chunk count, most first. chunk[c] =
// (lane, first pair, pairs, chunks of that lane). One CTA runs one chunk.
//
// What bounds it on an H100 SXM (NVIDIA H100 80GB HBM3, 700 W): per
// factorization of the npoint-129 Brusselator (184 rows) the distinct
// tiles each row reads, the lanes it writes and 2*BE^3 flops per pair give
// a bound of 2.79 ms for both widths on the live-lanes contract (0.56 ms at
// BE 32, 2.23 ms at BE 64) and 4.77 ms on the earlier contract that wrote
// all TL = 1024 lanes; bytes over 3.35 TB/s set it, the flops over the
// 67 TFLOP/s f64 tensor-core rate come close. The earlier design (one CTA
// per lane walking the lane's pairs in series with f64 FMAs) spent
// 64.1 ms there (PERF.md); three costs, and what this design does:
//  1. The longest lane set each row's time (up to 154 pairs in series at
//     npoint 129, 333 at 513). Here no CTA walks more than K pairs: a lane
//     with several chunks writes one f64 partial per chunk to `scratch`
//     (chunk c to row c: multi-chunk lanes come first), and the last of
//     its CTAs to finish (a per-lane ticket, `tickets`, reset by that CTA)
//     sums the partials in chunk order. No floating-point atomics and a
//     fixed summation order, so the output is bit-identical across
//     launches. Lanes with one chunk write their output directly.
//  2. All TL lanes were written; here only the n_live lanes are.
//  3. Plain FMAs at half the f64 rate, no copy/compute overlap. Here the
//     products run on the f64 tensor cores (mma.sync m16n8k4), and the
//     operand tiles stream through NSTAGE = 3 stages of shared memory with
//     16-byte cp.async, one stage per (pair, 32-deep k-slab), so the next
//     slabs load while the current one multiplies.
//     Rows of the L slab (32 + 4 doubles) and of the U slab (BE + 4) are
//     padded so that the fragment loads hit 16 distinct 8-byte bank pairs
//     per half-warp. At BE 64 a stage is 35 KB (two CTAs per SM), at BE 32
//     18 KB. At BE 16 one warp computes the whole 16 x 16 tile from one
//     16-deep slab a pair (5 KB a stage).
// A batch of L matrices factorized over one plan (the lanes of an ensemble
// of Radau5 integrations) shares the row's work list and index arrays: a
// second grid dimension runs over the lanes (blockIdx.y), and each lane's
// blocks, output, partials and tickets sit at their own lane offsets. Each
// lane's CTAs do what a one-lane launch does, so its bits are the same, and
// a row is one launch whatever L is.

#include <cuda_runtime.h>

namespace {

constexpr int NSTAGE = 3;   // cp.async stages
constexpr int PAD = 4;      // row padding (doubles) of the shared slabs

template <int BE>
struct Cfg {
  // depth of one k-slab: 32, or the whole block at BE 16
  static constexpr int KS = BE < 32 ? BE : 32;
  // warps along M and N: BE 16 -> one warp of 16 x 16; BE 32 -> 2 x 2
  // warps of 16 x 16; BE 64 -> 2 x 4 warps of 32 x 16
  static constexpr int WM = BE < 32 ? 1 : 2;
  static constexpr int WN = BE / 16;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int TM = BE / WM;     // warp tile rows
  static constexpr int TN = BE / WN;     // warp tile columns
  static constexpr int MT = TM / 16;     // m16 tiles per warp
  static constexpr int NT = TN / 8;      // n8 tiles per warp
  static constexpr int SA = KS + PAD;    // L slab row stride
  static constexpr int SB = BE + PAD;    // U slab row stride
  static constexpr int A_ELEMS = BE * SA;
  static constexpr int B_ELEMS = KS * SB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int SLABS = BE / KS;  // k-slabs per pair
  static constexpr int BB = BE * BE;
  static constexpr size_t SMEM = sizeof(double) * NSTAGE * STAGE;
};

__device__ __forceinline__ void cp_async16(double* smem, const double* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d (16 x 8) += a (16 x 4, row) * b (4 x 8, col) on the f64 tensor cores
// (sm_90). Fragments (g = lane / 4, t = lane % 4): a[0] = A[g][t],
// a[1] = A[g + 8][t]; b = B[t][g]; d[0..1] = D[g][2t..2t+1],
// d[2..3] = D[g + 8][2t..2t+1].
__device__ __forceinline__ void mma_16x8x4(double (&d)[4], const double (&a)[2],
                                           double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

template <int BE>
__global__ void __launch_bounds__(Cfg<BE>::THREADS, 2)
splu_pairs_kernel(const double* __restrict__ blocks,
                  const int* __restrict__ pair_l,
                  const int* __restrict__ pair_u,
                  const int4* __restrict__ chunk,
                  const int* __restrict__ lane_off,
                  int* __restrict__ tickets,
                  double* __restrict__ out,
                  double* __restrict__ scratch,
                  long long blocks_lane, int n_live, int n_multi) {
  using C = Cfg<BE>;
  constexpr int KS = C::KS;
  extern __shared__ __align__(16) double smem[];
  __shared__ int s_last;

  // this lane's blocks, output rows, partials and tickets
  blocks += blockIdx.y * blocks_lane;
  out += (size_t)blockIdx.y * n_live * C::BB;
  if (scratch) scratch += (size_t)blockIdx.y * n_multi * C::BB;
  tickets += (size_t)blockIdx.y * n_live;
  const int c = blockIdx.x;
  const int4 ck = chunk[c];           // lane, first pair, pairs, lane chunks
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int row0 = (warp / C::WN) * C::TM;
  const int col0 = (warp % C::WN) * C::TN;
  const int steps = ck.z * C::SLABS;

  // one (pair, k-slab) step: L[:, ks*KS : +KS] and U[ks*KS : +KS, :]
  auto load = [&](int step) {
    const int p = ck.y + step / C::SLABS;
    const int ks = step % C::SLABS;
    const double* L = blocks + (size_t)__ldg(pair_l + p) * C::BB + ks * KS;
    const double* U =
        blocks + (size_t)__ldg(pair_u + p) * C::BB + (size_t)ks * KS * BE;
    double* as = smem + (step % NSTAGE) * C::STAGE;
    double* bs = as + C::A_ELEMS;
#pragma unroll
    for (int i = tid; i < BE * KS / 2; i += C::THREADS) {
      const int r = i / (KS / 2), q = 2 * (i % (KS / 2));
      cp_async16(as + r * C::SA + q, L + r * BE + q);
    }
#pragma unroll
    for (int i = tid; i < KS * BE / 2; i += C::THREADS) {
      const int r = i / (BE / 2), q = 2 * (i % (BE / 2));
      cp_async16(bs + r * C::SB + q, U + r * BE + q);
    }
  };

  double acc[C::MT][C::NT][4];
#pragma unroll
  for (int m = 0; m < C::MT; ++m)
#pragma unroll
    for (int n = 0; n < C::NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.0;

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<NSTAGE - 2>();   // this step's slabs have landed
    __syncthreads();               // and every warp is done with step - 1
    if (step + NSTAGE - 1 < steps) load(step + NSTAGE - 1);
    cp_async_commit();
    const double* as = smem + (step % NSTAGE) * C::STAGE;
    const double* bs = as + C::A_ELEMS;
#pragma unroll
    for (int k = 0; k < KS; k += 4) {
      double a[C::MT][2], b[C::NT];
#pragma unroll
      for (int m = 0; m < C::MT; ++m) {
        a[m][0] = as[(row0 + 16 * m + g) * C::SA + k + t];
        a[m][1] = as[(row0 + 16 * m + g + 8) * C::SA + k + t];
      }
#pragma unroll
      for (int n = 0; n < C::NT; ++n) b[n] = bs[(k + t) * C::SB + col0 + 8 * n + g];
#pragma unroll
      for (int m = 0; m < C::MT; ++m)
#pragma unroll
        for (int n = 0; n < C::NT; ++n) mma_16x8x4(acc[m][n], a[m], b[n]);
    }
  }
  cp_async_wait<0>();

  const int lane = ck.x;
  const int cnt = ck.w;
  double* dst = cnt == 1 ? out + (size_t)lane * C::BB : scratch + (size_t)c * C::BB;
#pragma unroll
  for (int m = 0; m < C::MT; ++m)
#pragma unroll
    for (int n = 0; n < C::NT; ++n) {
      const int r = row0 + 16 * m + g;
      const int col = col0 + 8 * n + 2 * t;
      *reinterpret_cast<double2*>(dst + r * BE + col) =
          make_double2(acc[m][n][0], acc[m][n][1]);
      *reinterpret_cast<double2*>(dst + (r + 8) * BE + col) =
          make_double2(acc[m][n][2], acc[m][n][3]);
    }
  if (cnt == 1) return;

  // a multi-chunk lane: the last of its CTAs sums the partials in chunk
  // order (threadFenceReduction pattern: fence, then count)
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(tickets + lane, 1);
    s_last = prev == cnt - 1;
    if (s_last) tickets[lane] = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  constexpr int PER = C::BB / 2 / C::THREADS;
  const double2* part =
      reinterpret_cast<const double2*>(scratch + (size_t)lane_off[lane] * C::BB);
  double2 sum[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) sum[e] = __ldcg(part + tid + e * C::THREADS);
  for (int j = 1; j < cnt; ++j) {
    const double2* pj = part + (size_t)j * (C::BB / 2);
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const double2 v = __ldcg(pj + tid + e * C::THREADS);
      sum[e].x += v.x;
      sum[e].y += v.y;
    }
  }
  double2* o = reinterpret_cast<double2*>(out + (size_t)lane * C::BB);
#pragma unroll
  for (int e = 0; e < PER; ++e) o[tid + e * C::THREADS] = sum[e];
}

template <int BE>
cudaError_t launch(const double* blocks, const int* pair_l, const int* pair_u,
                   const int4* chunk, const int* lane_off, int* tickets,
                   int n_chunks, double* out, double* scratch, int lanes,
                   long long blocks_lane, int n_live, int n_multi,
                   cudaStream_t stream) {
  using C = Cfg<BE>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        splu_pairs_kernel<BE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  splu_pairs_kernel<BE><<<dim3(n_chunks, lanes), C::THREADS, C::SMEM,
                          stream>>>(blocks, pair_l, pair_u, chunk, lane_off,
                                    tickets, out, scratch, blocks_lane,
                                    n_live, n_multi);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 = launched). Launches on `stream`, does not
// synchronise and allocates nothing: the caller owns `out` (lanes, n_live,
// be*be), `scratch` (lanes, n_multi, be*be: one be*be row per chunk of the
// multi-chunk lanes; null when n_multi is 0) and `tickets` (lanes, n_live
// zeroed ints, left zeroed; launches that may overlap, on two streams, need
// two buffers). Lane l's blocks start at blocks + l * blocks_lane doubles.
// `chunk` is (n_chunks, 4) int32, 16-byte aligned, one list for every lane.
extern "C" int splu_pairs_f64(const double* blocks, const int* pair_l,
                              const int* pair_u, const int* chunk,
                              const int* lane_off, int* tickets, int n_chunks,
                              int n_live, int n_multi, int be, int lanes,
                              long long blocks_lane, double* out,
                              double* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // every live lane owns at least one chunk
  if (n_live <= 0 || n_chunks < n_live || lanes < 1 || lanes > 65535 ||
      n_multi < 0 || (n_multi && !scratch))
    return (int)cudaErrorInvalidValue;
  const int4* ck = reinterpret_cast<const int4*>(chunk);
  if (be == 16)
    return (int)launch<16>(blocks, pair_l, pair_u, ck, lane_off, tickets,
                           n_chunks, out, scratch, lanes, blocks_lane, n_live,
                           n_multi, s);
  if (be == 32)
    return (int)launch<32>(blocks, pair_l, pair_u, ck, lane_off, tickets,
                           n_chunks, out, scratch, lanes, blocks_lane, n_live,
                           n_multi, s);
  if (be == 64)
    return (int)launch<64>(blocks, pair_l, pair_u, ck, lane_off, tickets,
                           n_chunks, out, scratch, lanes, blocks_lane, n_live,
                           n_multi, s);
  return (int)cudaErrorInvalidValue;
}
