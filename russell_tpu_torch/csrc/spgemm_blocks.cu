// Numeric phase of the block SpGEMM C = A B, f64 or complex128, over the
// operands' live entries: a row-wise (Gustavson) product, each block row of C summed in
// shared memory and written once.
//
// Replaces: russell_tpu/sparse/kernels.py, _spgemm_pallas (the Pallas TPU
// kernel: one sequential grid step per block product, the output block
// selected by the scalar-prefetched c_idx, zeroed at c_first and
// accumulated across consecutive steps).
//
// The output is the reference's: dense (c_blocks, BM, BN) blocks in the
// order of the plan's c_block_ij, sorted by (block row i, block column j),
// so the C blocks of one block row are contiguous in C. Blocks that no
// live product reaches are zeros.
//
// What bounds it on an H100: writing C. The TPU kernel multiplies whole
// blocks, but the blocks of a banded matrix are mostly zeros: at 16x16 the
// npoint-513 Brusselator Jacobian's live blocks are about 1 % nonzero, and
// its A·A issues 21.8 GFLOP of block FMAs for 18.9 M live scalar products
// (37.8 MFLOP). The least bytes of the function are each live entry of A
// once (8-byte value, 4-byte column), the row structure, the C block
// columns, and C written once: 1.99 GB at npoint 513, of which C is 1.95 GB,
// about 0.6 ms at 3.35 TB/s. Live flops are 37.8 MFLOP against those bytes
// (0.02 flop/byte): this kernel moves bytes and needs no tensor cores.
//
// Operands: each matrix's entries as SpGEMM sees them (RowLayout,
// russell_tpu_torch/sparse/kernels.py): CSR over every row of every block
// row, the nonzero entries of the stored blocks of the slots with mask > 0,
// unscaled, a row's entries in column order (entries of one position from
// several slots side by side, in slot order). A's entries whose column k
// is past B's rows (block columns at or past B's block rows, which the
// plan drops) are skipped here.
//
// Design: the C blocks of block row i are c_row_ptr[i] .. c_row_ptr[i+1],
// with block columns c_col. A strip of them is zeroed in shared memory,
// laid out as C is (block, row, column), summed into, and written to C once
// as one contiguous run of 16-byte streaming stores (C is not read back),
// which leave the strip zero again. A group of 8 lanes walks one row r of
// A: lane e holds A entry e (a_rk) and B's row range for k, and for each A
// entry in column order the lanes take the entries b_kj of B's row k, each
// adding a_rk * b_kj to the strip at (slot of j / BN, r, j % BN); the slot
// is a binary search over the chunk's block columns in shared memory.
// Control flow is warp-uniform: the four groups of a warp walk rows of
// other lengths side by side, so none waits on another's branch. One A
// entry's B row puts each lane on its own position, so a position's sum
// runs over the row's A entries in column order, the same at every launch:
// no float atomics, bit-identical output. Where a B row holds one column
// twice (duplicated block columns), the lanes of that pass add one after
// the other in entry order. Products are rounded as __dmul_rn then
// __dadd_rn (no FMA contraction), so a sequential walk in that order gives
// the same bits.
//
// What the time goes to, and the answer: a row's loads are a dependent
// chain (row pointer, A entries, B row pointers, B entries), about as long
// as writing its strip, and a strip (59 KB at 16x16) leaves room for three
// CTAs an SM. So a CTA has two warp sets and one strip and walks kTurns
// block rows, blockIdx.x + turn * gridDim.x (the CTAs on the card at one
// time write neighbouring runs of C); the sets take turns. Each set loads
// its next block row's A entries and first B entries into registers before
// it takes the strip, so that chain overlaps the other set's sums and
// stores; then it sums from registers, stores, and hands the strip on
// (named barriers). On an H100 at npoint 513 this took A·A from 1.14 ms
// (one CTA per block row, loads after the strip was ready) to 0.71 ms,
// against 0.60 ms for the bytes and 0.59 ms for C.zero_() alone.
//
// Fit: a block row whose strip exceeds the shared memory the wrapper
// budgets is cut into chunks of chunk_blocks C blocks, each re-walking the
// row's entries and skipping columns outside it; a block too large for the
// budget is cut into runs of chunk_rows rows (one block a chunk). Either
// way a chunk is one contiguous run of C. Offsets into C are 64-bit.
//
// complex128 (value.cuh): the same kernel over 16-byte values, each
// product (ar br - ai bi, ar bi + ai br) with every product and sum
// rounded apart; the strip holds half as many values in the same bytes,
// and the registers are budgeted for two CTAs an SM, not three (a complex
// Batch holds twice the registers).

#include <cstdint>
#include <cuda_runtime.h>

#include "value.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSets = 2;                      // warp sets taking turns
constexpr int kSetThreads = kThreads / kSets;
constexpr int kGroup = 8;                     // lanes that walk one row of A
constexpr int kGroups = kSetThreads / kGroup; // rows a set walks at once
constexpr int kTurns = 4;                     // block rows of one CTA
constexpr unsigned kFull = 0xffffffffu;
static_assert(kGroup <= 32 && (kGroup & (kGroup - 1)) == 0, "kGroup");
static_assert(kSetThreads % 32 == 0, "whole warps a set");

// Barriers: 1 + set among the set's threads; 1 + kSets + set where the
// set hands the strip to the next (it arrives, the next set waits). The
// hand-over counts the threads of both sets.
static_assert(2 * kSets < 16, "named barriers");
__device__ __forceinline__ void set_sync(int set) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + set), "n"(kSetThreads)
               : "memory");
}
__device__ __forceinline__ void strip_release(int set) {
  asm volatile("bar.arrive %0, %1;" ::"r"(1 + kSets + set),
               "n"(2 * kSetThreads)
               : "memory");
}
__device__ __forceinline__ void strip_acquire(int set) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + kSets + (set + kSets - 1) %
                                                          kSets),
               "n"(2 * kSetThreads)
               : "memory");
}

// Slot of block column jb among the chunk's sorted block columns, or -1.
__device__ __forceinline__ int find_slot(const int* cols, int nb, int jb) {
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cols[mid] < jb) lo = mid + 1;
    else hi = mid;
  }
  return lo < nb && cols[lo] == jb ? lo : -1;
}

// Strip position of (row rr of the chunk, global column j), or -1 when j
// is no column (j < 0) or its block is outside the chunk.
__device__ __forceinline__ int strip_pos(const int* cols, int nb, int nr,
                                         int rr, int bn, int j) {
  const int jb = max(j, 0) / bn;
  const int s = find_slot(cols, nb, jb);
  return s < 0 || j < 0 ? -1 : (s * nr + rr) * bn + (j - jb * bn);
}

// One pass of a warp: each lane with a product (pos >= 0) adds v to the
// strip. Lanes of a group that share a column (a B row holding it twice)
// add one after the other in lane order.
template <typename T>
__device__ __forceinline__ void add_pass(T* strip, int pos, int j, T v,
                                         int lane) {
  const int prev = __shfl_up_sync(kFull, j, 1, kGroup);
  const bool dup = lane > 0 && j >= 0 && prev == j;
  if (__any_sync(kFull, dup)) {
    for (int l = 0; l < kGroup; ++l) {
      if (lane == l && pos >= 0) strip[pos] = vadd_rn(strip[pos], v);
      __syncwarp();
    }
  } else if (pos >= 0) {
    strip[pos] = vadd_rn(strip[pos], v);
  }
  __syncwarp();
}

// A batch of a group: A entries e0 .. e0 + ne - 1 of its row (0 <= ne <=
// kGroup), lane e holding entry e: B's row range (bs, bl) for its column
// k (none when k is past B's rows), its value, and the first kGroup
// entries of each of those B rows, lane l holding entry l of the row of A
// entry t in (jv[t], bv[t]) (column -1: none). The products are formed at
// the adds, so that nothing waits on these loads before the strip is
// ready.
template <typename T>
struct Batch {
  long long bs;
  T av;
  int bl, ne;
  int jv[kGroup];
  T bv[kGroup];
};

template <typename T>
__device__ __forceinline__ void load_batch(
    const int* __restrict__ a_col, const T* __restrict__ a_val,
    const long long* __restrict__ b_ptr, const int* __restrict__ b_col,
    const T* __restrict__ b_val, int b_rows, long long e0, long long hi,
    int lane, Batch<T>& x) {
  x.ne = (int)max(0LL, min((long long)kGroup, hi - e0));
  x.bs = 0;
  x.av = vzero<T>();
  x.bl = 0;
  if (lane < x.ne) {
    const int k = a_col[e0 + lane];
    x.av = a_val[e0 + lane];
    if (k < b_rows) {
      x.bs = b_ptr[k];
      x.bl = (int)(b_ptr[k + 1] - x.bs);
    }
  }
#pragma unroll
  for (int t = 0; t < kGroup; ++t) {
    const int len = __shfl_sync(kFull, x.bl, t, kGroup);
    const long long st = __shfl_sync(kFull, x.bs, t, kGroup);
    const bool live = lane < len;
    x.jv[t] = live ? __ldg(b_col + st + lane) : -1;
    x.bv[t] = live ? vldg(b_val + st + lane) : vzero<T>();
  }
}

// The batch's products into strip row rr, A entry by A entry in column
// order: the loaded first kGroup entries of its B row, then the rest of a
// longer row, before the next A entry. Control flow is the same for the
// whole warp (its groups walk rows of other lengths side by side).
template <typename T>
__device__ __forceinline__ void add_batch(const int* __restrict__ b_col,
                                          const T* __restrict__ b_val,
                                          const Batch<T>& x, T* strip,
                                          const int* cols, int nb, int nr,
                                          int rr, int bn, int lane) {
#pragma unroll
  for (int t = 0; t < kGroup; ++t) {
    if (!__any_sync(kFull, t < x.ne)) break;
    const T a = vshfl(kFull, x.av, t, kGroup);
    add_pass(strip, strip_pos(cols, nb, nr, rr, bn, x.jv[t]), x.jv[t],
             vmul_rn(a, x.bv[t]), lane);
    const int len = __shfl_sync(kFull, x.bl, t, kGroup);
    if (!__any_sync(kFull, len > kGroup)) continue;
    const long long st = __shfl_sync(kFull, x.bs, t, kGroup);
    for (int off = kGroup; __any_sync(kFull, off < len); off += kGroup) {
      const bool live = off + lane < len;
      const int j = live ? __ldg(b_col + st + off + lane) : -1;
      const T v =
          live ? vmul_rn(a, vldg(b_val + st + off + lane)) : vzero<T>();
      add_pass(strip, strip_pos(cols, nb, nr, rr, bn, j), j, v, lane);
    }
  }
}

// n doubles from the shared strip to C by the set's threads, with 16-byte
// streaming stores (a lone leading or trailing double where C's run is not
// 16-byte aligned), leaving zeros in the strip: the next turn finds it
// clear.
__device__ __forceinline__ void store_run(double* __restrict__ dst,
                                          double* src, int n, int stid) {
  const int head = ((reinterpret_cast<uintptr_t>(dst) & 15) && n > 0) ? 1 : 0;
  if (stid == 0 && head) {
    __stcs(dst, src[0]);
    src[0] = 0.0;
  }
  dst += head;
  src += head;
  n -= head;
  const int n2 = n >> 1;
  double2* d2 = reinterpret_cast<double2*>(dst);
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    double2* s2 = reinterpret_cast<double2*>(src);
    for (int e = stid; e < n2; e += kSetThreads) {
      const double2 v = s2[e];
      s2[e] = make_double2(0.0, 0.0);
      __stcs(d2 + e, v);
    }
  } else {
    for (int e = stid; e < n2; e += kSetThreads) {
      __stcs(d2 + e, make_double2(src[2 * e], src[2 * e + 1]));
      src[2 * e] = src[2 * e + 1] = 0.0;
    }
  }
  if (stid == 0 && (n & 1)) {
    __stcs(dst + n - 1, src[n - 1]);
    src[n - 1] = 0.0;
  }
}

// The same for complex values: each is one 16-byte streaming store.
__device__ __forceinline__ void store_run(double2* __restrict__ dst,
                                          double2* src, int n, int stid) {
  for (int e = stid; e < n; e += kSetThreads) {
    const double2 v = src[e];
    src[e] = make_double2(0.0, 0.0);
    __stcs(dst + e, v);
  }
}

// CTAs an SM the registers are budgeted for: three strips of 64 KB fit an
// SM's shared memory; a complex Batch needs more registers than a third of
// the SM's gives 256 threads
template <typename T>
constexpr int min_ctas() {
  return sizeof(T) == sizeof(double) ? 3 : 2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, min_ctas<T>())
    spgemm_rows_kernel(const long long* __restrict__ a_ptr,
                       const int* __restrict__ a_col,
                       const T* __restrict__ a_val,
                       const long long* __restrict__ b_ptr,
                       const int* __restrict__ b_col,
                       const T* __restrict__ b_val, int b_rows,
                       const long long* __restrict__ c_row_ptr,
                       const int* __restrict__ c_col, int n_block_rows,
                       int bm, int bn, int chunk_rows, int chunk_blocks,
                       T* __restrict__ C) {
  extern __shared__ __align__(16) double smem[];
  T* strip = reinterpret_cast<T*>(smem);
  int* cols = reinterpret_cast<int*>(strip + (size_t)chunk_rows *
                                                 chunk_blocks * bn);
  const int tid = threadIdx.x;
  const int set = tid / kSetThreads;
  const int stid = tid % kSetThreads;
  const int lane = stid % kGroup;
  const int grp = stid / kGroup;
  // block rows blockIdx.x + turn * gridDim.x: the CTAs on the card at one
  // time write neighbouring runs of C
  const int turns = (int)min(
      (long long)kTurns, ((long long)n_block_rows - blockIdx.x + gridDim.x -
                          1) / (long long)gridDim.x);
  // the strip starts zero and every turn leaves it so (store_run)
  const int n_words =
      chunk_rows * chunk_blocks * bn * (int)(sizeof(T) / sizeof(double));
  double2* z = reinterpret_cast<double2*>(smem);
  for (int e = tid; e < (n_words >> 1); e += kThreads)
    z[e] = make_double2(0.0, 0.0);
  if (tid == 0 && (n_words & 1)) smem[n_words - 1] = 0.0;
  __syncthreads();
  // set s takes turns s, s + kSets, ...; the strip is handed over between
  // turns
  for (int turn = set; turn < turns; turn += kSets) {
    const long long i = blockIdx.x + (long long)turn * gridDim.x;
    const long long c_lo = c_row_ptr[i], c_hi = c_row_ptr[i + 1];
    bool held = false;
    for (long long c0 = c_lo; c0 < c_hi; c0 += chunk_blocks) {
      const int nb = (int)min((long long)chunk_blocks, c_hi - c0);
      for (int r0 = 0; r0 < bm; r0 += chunk_rows) {
        const int nr = min(chunk_rows, bm - r0);
        const int n = nb * nr * bn;
        // the group's first row: its first A entries and their B rows are
        // loaded before the strip is this set's, so the loads' latency
        // overlaps the other sets' sums and stores
        long long e0 = 0, hi = 0;
        if (grp < nr) {
          e0 = a_ptr[i * bm + r0 + grp];
          hi = a_ptr[i * bm + r0 + grp + 1];
        }
        Batch<T> x;
        load_batch(a_col, a_val, b_ptr, b_col, b_val, b_rows, e0, hi, lane,
                   x);
        const int cv = stid < nb ? c_col[c0 + stid] : 0;
        if (held) set_sync(set);  // the previous chunk's stores read it
        else if (turn > 0) strip_acquire(set);
        held = true;
        if (stid < nb) cols[stid] = cv;
        for (int e = stid + kSetThreads; e < nb; e += kSetThreads)
          cols[e] = c_col[c0 + e];
        set_sync(set);
        // the chunk's rows, kGroups at a time; each row's A entries in
        // column order, kGroup at a time
        for (int rb = 0; rb < nr; rb += kGroups) {
          const int rr = rb + grp;
          if (rb > 0) {
            e0 = hi = 0;
            if (rr < nr) {
              e0 = a_ptr[i * bm + r0 + rr];
              hi = a_ptr[i * bm + r0 + rr + 1];
            }
            load_batch(a_col, a_val, b_ptr, b_col, b_val, b_rows, e0, hi,
                       lane, x);
          }
          while (true) {
            add_batch(b_col, b_val, x, strip, cols, nb, nr, rr, bn, lane);
            e0 += kGroup;
            if (!__any_sync(kFull, e0 < hi)) break;
            load_batch(a_col, a_val, b_ptr, b_col, b_val, b_rows, e0, hi,
                       lane, x);
          }
        }
        set_sync(set);
        // blocks c0 .. c0 + nb - 1 whole, or rows r0 .. r0 + nr - 1 of
        // block c0 alone: one run of C either way
        T* dst = C + ((size_t)c0 * bm + r0) * bn;
        store_run(dst, strip, n, stid);
      }
    }
    // a block row without C blocks still takes the strip and hands it on,
    // so that every hand-over barrier completes
    if (!held && turn > 0) strip_acquire(set);
    if (turn + 1 < turns) strip_release(set);
  }
}

template <typename T>
int launch(const long long* a_ptr, const int* a_col, const T* a_val,
           const long long* b_ptr, const int* b_col, const T* b_val,
           int b_rows, const long long* c_row_ptr, const int* c_col,
           int n_block_rows, int bm, int bn, int chunk_rows, int chunk_blocks,
           T* C, void* stream) {
  if (n_block_rows <= 0) return (int)cudaGetLastError();
  if (bm <= 0 || bn <= 0 || chunk_rows <= 0 || chunk_rows > bm ||
      chunk_blocks <= 0 || (chunk_rows < bm && chunk_blocks != 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * (size_t)chunk_rows * chunk_blocks * bn +
                      sizeof(int) * (size_t)chunk_blocks;
  cudaError_t err = cudaFuncSetAttribute(
      spgemm_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n_block_rows + kTurns - 1) / kTurns);
  spgemm_rows_kernel<T><<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      a_ptr, a_col, a_val, b_ptr, b_col, b_val, b_rows, c_row_ptr, c_col,
      n_block_rows, bm, bn, chunk_rows, chunk_blocks, C);
  return (int)cudaGetLastError();
}

}  // namespace

// Return a cudaError_t code (0 = launched). Launch on `stream`, do not
// synchronise and allocate nothing: the caller owns `C` (c_blocks, bm,
// bn). a_* and b_* are the operands' RowLayouts (row pointers of a.nbr * bm
// + 1 and b_rows + 1 entries); c_row_ptr holds n_block_rows + 1 offsets
// into c_col and C. A chunk is chunk_blocks whole blocks (chunk_rows = bm)
// or chunk_rows < bm rows of one block (chunk_blocks = 1).
extern "C" int spgemm_blocks_f64(const long long* a_ptr, const int* a_col,
                                 const double* a_val, const long long* b_ptr,
                                 const int* b_col, const double* b_val,
                                 int b_rows, const long long* c_row_ptr,
                                 const int* c_col, int n_block_rows, int bm,
                                 int bn, int chunk_rows, int chunk_blocks,
                                 double* C, void* stream) {
  return launch(a_ptr, a_col, a_val, b_ptr, b_col, b_val, b_rows, c_row_ptr,
                c_col, n_block_rows, bm, bn, chunk_rows, chunk_blocks, C,
                stream);
}

extern "C" int spgemm_blocks_c128(const long long* a_ptr, const int* a_col,
                                  const double2* a_val,
                                  const long long* b_ptr, const int* b_col,
                                  const double2* b_val, int b_rows,
                                  const long long* c_row_ptr,
                                  const int* c_col, int n_block_rows, int bm,
                                  int bn, int chunk_rows, int chunk_blocks,
                                  double2* C, void* stream) {
  return launch(a_ptr, a_col, a_val, b_ptr, b_col, b_val, b_rows, c_row_ptr,
                c_col, n_block_rows, bm, bn, chunk_rows, chunk_blocks, C,
                stream);
}
