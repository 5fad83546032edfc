// probe / probe2: batched binary search on the GPU.
//
// probe replaces materialize_tpu/ops/kernels/probe.py::_pallas_searchsorted.
// It runs the same unrolled loop as the JAX reference (_xla_searchsorted):
// ceil(log2 n) + 1 compare/select steps whose count depends only on n, so the
// warp never diverges. One thread per query. Bound on the H100: bytes and
// latency. Each query reads one 8-byte key and writes one 8-byte position; the
// sorted array is read at log2(n) dependent addresses per query. The top levels
// of the implicit search tree are shared by every query and stay in L2 (and
// L1, through __ldg); the bottom levels are one dependent global load each.
//
// probe2 replaces ::_pallas_searchsorted2: the insertion point of each (q_hi,
// q_lo) in the pair-sorted (a_hi, a_lo), compared lexicographically, on the
// left or the right side. Precondition, as for the reference: `a` is sorted
// by (hi, lo). Its callers (ops/consolidate.py::_merge_perm and
// ops/reduce.py::merge_consolidate_accums) search one sorted run in another,
// a merge, so neighbouring queries end at neighbouring positions. Bound on the
// H100: bytes, the 16 bytes of each query, 16 bytes of each row of `a` and
// 8 bytes of output. A per-thread search walks ~22 dependent levels of two
// arrays from DRAM for every query; this kernel instead reads `a` about once:
//   1. each block takes a tile of kTileRows consecutive queries (kItems a
//      thread, striped, so loads and stores are coalesced), and votes
//      (__syncthreads_and) whether the tile is sorted;
//   2. meanwhile four warps find, by a 32-way search (one ballot a level,
//      5 dependent loads at n = 2^21), lb and ub of the tile's first and last
//      query (lb: the left-side insertion point, ub: the right-side one);
//   3. in a sorted tile every query equal to the first or the last gets its
//      answer from those; every query strictly between lies in the window
//      [ub(first), lb(last)) of `a`, the rows strictly between the two, which
//      does not grow with a run of equal rows (PAD_HASH padding) at either
//      end. A window of at most kWindowRows rows is staged into shared memory
//      in coalesced loads and searched there, all of a thread's queries in
//      lockstep; a larger one is searched in global memory within its bounds;
//   4. an unsorted tile runs the reference's full-depth loop per query.
// Every branch returns the exact insertion point, so the output equals the
// reference's on every input that meets the precondition.
//
// Every column is int64 here: the port carries u32 hashes as int64 in
// [0, 2^32), and the join also searches its int64 prefix sum of match counts.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;

template <bool RIGHT>
__device__ __forceinline__ bool pred(int64_t a, int64_t q) {
  return RIGHT ? (a <= q) : (a < q);
}

template <bool RIGHT>
__device__ __forceinline__ bool pred2(int64_t ah, int64_t al, int64_t qh, int64_t ql) {
  return (ah < qh) || ((ah == qh) && (RIGHT ? (al <= ql) : (al < ql)));
}

template <bool RIGHT>
__global__ void probe_kernel(const int64_t* __restrict__ a, int64_t n,
                             const int64_t* __restrict__ q, int64_t m,
                             int64_t* __restrict__ out) {
  int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int64_t qv = q[j];
  int64_t pos = 0;
  for (int64_t cur = n; cur > 1;) {
    const int64_t half = cur >> 1;
    pos = pred<RIGHT>(__ldg(a + pos + half - 1), qv) ? pos + half : pos;
    cur -= half;
  }
  out[j] = pos + (pred<RIGHT>(__ldg(a + pos), qv) ? 1 : 0);
}

// -- probe2 -------------------------------------------------------------------

// Settled on the H100 over tiles of 512-4096 queries and windows of 2048-8192
// rows at the main path's calls: the 32 KB window needs no opt-in above the
// 48 KB default and leaves room for six blocks an SM.
constexpr int kItems = 4;                        // queries a thread
constexpr int64_t kTileRows = kThreads * kItems; // queries a block
constexpr int kWindowRows = 2048;                // rows of `a` in shared memory
constexpr int kStage = 4;                        // rows a thread stages at once

struct alignas(16) Pair {
  int64_t hi, lo;
};

// The rows of `a` as the searches read them: from global memory, or from the
// window staged in shared memory (row i of `a` at win[i - base]).
struct GlobalRows {
  const int64_t* __restrict__ hi;
  const int64_t* __restrict__ lo;
  __device__ __forceinline__ Pair operator[](int64_t i) const {
    return Pair{__ldg(hi + i), __ldg(lo + i)};
  }
};

struct SharedRows {
  const Pair* win;
  int64_t base;
  __device__ __forceinline__ Pair operator[](int64_t i) const { return win[i - base]; }
};

// The reference's unrolled search over rows [lo, hi) of `a`, for every query
// of the thread at once (independent loads in flight): pos[k] is the
// insertion point of query k if it lies in [lo, hi]. With lo = 0, hi = n it
// is _xla_searchsorted2 step for step.
template <bool RIGHT, typename Rows>
__device__ __forceinline__ void search_rows(const Rows& a, int64_t lo, int64_t hi,
                                            const int64_t (&qh)[kItems],
                                            const int64_t (&ql)[kItems],
                                            int64_t (&pos)[kItems]) {
#pragma unroll
  for (int k = 0; k < kItems; ++k) pos[k] = lo;
  if (hi <= lo) return;
  for (int64_t cur = hi - lo; cur > 1;) {
    const int64_t half = cur >> 1;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const Pair r = a[pos[k] + half - 1];
      pos[k] = pred2<RIGHT>(r.hi, r.lo, qh[k], ql[k]) ? pos[k] + half : pos[k];
    }
    cur -= half;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const Pair r = a[pos[k]];
    pos[k] += pred2<RIGHT>(r.hi, r.lo, qh[k], ql[k]) ? 1 : 0;
  }
}

// Insertion point of (qh, ql) in a[0, n), by one warp: each level probes 32
// evenly spaced rows of the candidate range and keeps the stretch between
// the last row that satisfies the predicate and the first that does not.
template <bool RIGHT>
__device__ int64_t warp_search(const GlobalRows& a, int64_t n, int64_t qh, int64_t ql,
                               int lane) {
  int64_t lo = 0, hi = n;  // the insertion point lies in [lo, hi]
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t i = lo + (int64_t)(lane + 1) * step - 1;
    bool t = false;
    if (i < hi) {
      const Pair r = a[i];
      t = pred2<RIGHT>(r.hi, r.lo, qh, ql);
    }
    const int64_t k = __popc(__ballot_sync(0xffffffffu, t));
    const int64_t next_hi = lo + (k + 1) * step - 1;
    lo += k * step;
    hi = next_hi < hi ? next_hi : hi;
  }
  bool t = false;
  if (lo + lane < hi) {
    const Pair r = a[lo + lane];
    t = pred2<RIGHT>(r.hi, r.lo, qh, ql);
  }
  return lo + __popc(__ballot_sync(0xffffffffu, t));
}

__device__ __forceinline__ bool pair_le(int64_t ah, int64_t al, int64_t bh, int64_t bl) {
  return ah < bh || (ah == bh && al <= bl);
}

template <bool RIGHT>
__global__ void __launch_bounds__(kThreads)
probe2_tile_kernel(const int64_t* __restrict__ ah, const int64_t* __restrict__ al, int64_t n,
                   const int64_t* __restrict__ qh, const int64_t* __restrict__ ql, int64_t m,
                   int64_t* __restrict__ out) {
  __shared__ Pair win[kWindowRows];
  __shared__ int64_t bound[4];  // lb(first), ub(first), lb(last), ub(last)
  const GlobalRows a{ah, al};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t base = (int64_t)blockIdx.x * kTileRows;
  const int64_t end = (m - base < kTileRows) ? m : base + kTileRows;

  // 1. the tile's queries, striped; rows past the end repeat the last query
  int64_t vh[kItems], vl[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    int64_t j = base + tid + (int64_t)k * kThreads;
    j = j < end ? j : end - 1;
    vh[k] = qh[j];
    vl[k] = ql[j];
  }
  const int64_t fh = __ldg(qh + base), fl = __ldg(ql + base);
  const int64_t lh = __ldg(qh + end - 1), ll = __ldg(ql + end - 1);

  // 2. lb and ub of the first and the last query, one warp each
  if (warp < 4) {
    const bool last = warp >= 2;
    const int64_t sh = last ? lh : fh, sl = last ? ll : fl;
    const int64_t r = (warp & 1) ? warp_search<true>(a, n, sh, sl, lane)
                                 : warp_search<false>(a, n, sh, sl, lane);
    if (lane == 0) bound[warp] = r;
  }

  bool ordered = true;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    int64_t ph = __shfl_up_sync(0xffffffffu, vh[k], 1);
    int64_t pl = __shfl_up_sync(0xffffffffu, vl[k], 1);
    const int64_t j = base + tid + (int64_t)k * kThreads;
    if (lane == 0 && j > base && j < end) {
      ph = __ldg(qh + j - 1);
      pl = __ldg(ql + j - 1);
    }
    if (j > base && j < end) ordered = ordered && pair_le(ph, pl, vh[k], vl[k]);
  }
  const bool sorted = __syncthreads_and(ordered);

  int64_t pos[kItems];
  if (!sorted) {
    // 4. an unsorted tile: the reference's loop over all of `a`
    search_rows<RIGHT>(a, 0, n, vh, vl, pos);
  } else {
    // 3. a sorted tile: the first's and the last's answers, and the window
    const int64_t r_first = bound[RIGHT ? 1 : 0], r_last = bound[RIGHT ? 3 : 2];
    const int64_t wlo = bound[1], whi = bound[2];
    const bool between = !(fh == lh && fl == ll);  // some query may lie strictly between
    if (between && whi - wlo <= kWindowRows) {
      const int w = (int)(whi - wlo);
      for (int i0 = 0; i0 < w; i0 += kThreads * kStage) {
        Pair r[kStage];  // kStage loads in flight a thread
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int i = i0 + u * kThreads + tid;
          if (i < w) r[u] = a[wlo + i];
        }
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int i = i0 + u * kThreads + tid;
          if (i < w) win[i] = r[u];
        }
      }
      __syncthreads();
      search_rows<RIGHT>(SharedRows{win, wlo}, wlo, whi, vh, vl, pos);
    } else if (between) {
      search_rows<RIGHT>(a, wlo, whi, vh, vl, pos);
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (vh[k] == fh && vl[k] == fl) pos[k] = r_first;
      else if (vh[k] == lh && vl[k] == ll) pos[k] = r_last;
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t j = base + tid + (int64_t)k * kThreads;
    if (j < end) out[j] = pos[k];
  }
}

inline unsigned blocks_for(int64_t m) { return (unsigned)((m + kThreads - 1) / kThreads); }

}  // namespace

// a[n] sorted ascending, q[m] -> out[m] insertion points in [0, n], all on
// CUDA device `device`. n > 0 and m > 0 (the caller returns early otherwise).
// side: 0 left, 1 right.
extern "C" int mz_probe(int device, const void* a, int64_t n, const void* q, int64_t m,
                        int side, void* out, void* stream) {
  mz::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  cudaStream_t st = (cudaStream_t)stream;
  if (side)
    probe_kernel<true><<<blocks_for(m), kThreads, 0, st>>>(
        (const int64_t*)a, n, (const int64_t*)q, m, (int64_t*)out);
  else
    probe_kernel<false><<<blocks_for(m), kThreads, 0, st>>>(
        (const int64_t*)a, n, (const int64_t*)q, m, (int64_t*)out);
  return (int)cudaGetLastError();
}

// The same over (hi, lo) pairs compared lexicographically; `a` pair-sorted.
extern "C" int mz_probe2(int device, const void* a_hi, const void* a_lo, int64_t n,
                         const void* q_hi, const void* q_lo, int64_t m, int side, void* out,
                         void* stream) {
  mz::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned tiles = (unsigned)((m + kTileRows - 1) / kTileRows);
  if (side)
    probe2_tile_kernel<true><<<tiles, kThreads, 0, st>>>(
        (const int64_t*)a_hi, (const int64_t*)a_lo, n, (const int64_t*)q_hi,
        (const int64_t*)q_lo, m, (int64_t*)out);
  else
    probe2_tile_kernel<false><<<tiles, kThreads, 0, st>>>(
        (const int64_t*)a_hi, (const int64_t*)a_lo, n, (const int64_t*)q_hi,
        (const int64_t*)q_lo, m, (int64_t*)out);
  return (int)cudaGetLastError();
}
