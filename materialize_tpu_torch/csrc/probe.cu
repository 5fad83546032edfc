// probe / probe2: batched binary search on the GPU, one tile kernel for both.
//
// probe replaces materialize_tpu/ops/kernels/probe.py::_pallas_searchsorted:
// the insertion point of each int64 query q in the sorted int64 a[n], on the
// left or the right side. probe2 replaces ::_pallas_searchsorted2: the same
// over (hi, lo) pairs compared lexicographically, `a` pair-sorted. Both keys
// go through one template (Key1, Key2 below), so every branch exists once.
//
// Bound on the H100: bytes, each query read once, each answer written once,
// and each row of `a` the queries need read once. A thread per query walks
// ~23 dependent levels of `a` from DRAM for every query; this kernel does
// that only for unsorted queries, because every caller searches sorted ones
// (delta hashes out of a sort or a merge, `arange` over a prefix sum), so
// neighbouring queries end at neighbouring rows:
//   1. each block takes a tile of kTile consecutive queries; each warp owns a
//      contiguous 32 * kItems of them (kItems a lane, striped across the
//      lanes, so loads and stores are coalesced); the block votes
//      (__syncthreads_and) whether the tile is sorted;
//   2. meanwhile warps find, by a warp-wide search (32 rows probed a level,
//      one ballot a level), lb and ub of the tile's first and last query
//      (lb: the left-side insertion point, ub: the right-side one); two
//      warps when first == last, four otherwise;
//   3. in a sorted tile every query equal to the first or the last gets its
//      answer from those: all of an all-equal tile (PAD_HASH padding, most
//      tiles of the main path), which then costs its queries' read and its
//      answers' write and two searches. Every query strictly between lies in
//      the window [ub(first), lb(last)) of `a`, which excludes the runs equal
//      to either end. A window of at most kWindow rows is staged into shared
//      memory by the whole block (cp.async, every copy in flight) and
//      searched there, all of a thread's queries in lockstep;
//   4. a wider window is split into kWindow sub-windows of `stride` rows: the
//      block stages every stride-th row (an even sample, which bounds the
//      sub-windows), each query finds its sub-window by a search of the
//      sample in shared memory, then searches the stride - 1 rows strictly
//      inside it, in global memory, by a kWays-way search (log_kWays(stride)
//      dependent steps, all of a thread's queries and probes in flight at
//      once). The measured branch mix (PERF.md) decided this over streaming
//      whole sub-windows through shared memory: on the main path a few
//      sparse tiles span up to two million rows for a thousand live
//      queries, where a stream reads rows that no query needs. It also
//      measured faster than the reference's loop bounded to the window, in
//      global memory, on `probe2`'s sharded calls;
//   5. an unsorted tile runs the reference's full-depth loop per query.
// Every branch returns the exact insertion point, so the output equals the
// reference's on every input that meets the precondition (`a` sorted).
//
// Every column is int64: the port carries u32 hashes as int64 in [0, 2^32),
// and the join also searches its int64 prefix sum of match counts. The
// shapes below were settled by a sweep on the card over every call of both
// paths (PERF.md, scripts/port_kernel_sweep.py). `probe`'s window is small on
// purpose: its all-equal tiles, most of its work, stream through L1, which
// shares its SRAM with the blocks' shared memory, and with it tiles of 512
// queries spread the few sparse tiles of the main path over twice the SMs
// that tiles of 1024 do. `probe2` keeps 2,048 staged rows: its wide windows
// are dense, and a larger window leaves fewer of them to sample.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cuda_pipeline.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWays = 4;  // probes a level of the search between two samples

// -- the two keys -------------------------------------------------------------

struct Key1 {
  int64_t v;
};

struct alignas(16) Key2 {
  int64_t hi, lo;
};

__device__ __forceinline__ bool less(const Key1& a, const Key1& b) { return a.v < b.v; }
// Without a branch: both columns of a row are compared once both have
// arrived (a branch on hi measured far slower on probe2's calls, PERF.md).
__device__ __forceinline__ bool less(const Key2& a, const Key2& b) {
  return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo));
}
template <typename K>
__device__ __forceinline__ bool equal(const K& a, const K& b) {
  return !less(a, b) && !less(b, a);
}
// Row a lies before the insertion point of q: left a < q, right a <= q.
template <bool RIGHT, typename K>
__device__ __forceinline__ bool pred(const K& a, const K& q) {
  return RIGHT ? !less(q, a) : less(a, q);
}

__device__ __forceinline__ Key1 shfl(const Key1& k, int src) {
  return Key1{__shfl_sync(kFull, k.v, src)};
}
__device__ __forceinline__ Key2 shfl(const Key2& k, int src) {
  return Key2{__shfl_sync(kFull, k.hi, src), __shfl_sync(kFull, k.lo, src)};
}
__device__ __forceinline__ Key1 shfl_up(const Key1& k) {
  return Key1{__shfl_up_sync(kFull, k.v, 1)};
}
__device__ __forceinline__ Key2 shfl_up(const Key2& k) {
  return Key2{__shfl_up_sync(kFull, k.hi, 1), __shfl_up_sync(kFull, k.lo, 1)};
}

// The columns of a key in global memory: row i as a key, or copied into
// shared memory asynchronously (cp.async, 8 bytes a column, no registers).
// stream(i) loads row i of the queries, read once: probe2's go through the
// streaming path (__ldcs, evicted first), which measured faster there.
struct Cols1 {
  const int64_t* __restrict__ v;
  __device__ __forceinline__ Key1 operator[](int64_t i) const { return Key1{__ldg(v + i)}; }
  __device__ __forceinline__ Key1 stream(int64_t i) const { return Key1{v[i]}; }
  __device__ __forceinline__ void copy_async(Key1* dst, int64_t i) const {
    __pipeline_memcpy_async(&dst->v, v + i, 8);
  }
};

struct Cols2 {
  const int64_t* __restrict__ hi;
  const int64_t* __restrict__ lo;
  __device__ __forceinline__ Key2 operator[](int64_t i) const {
    return Key2{__ldg(hi + i), __ldg(lo + i)};
  }
  __device__ __forceinline__ Key2 stream(int64_t i) const {
    return Key2{(int64_t)__ldcs((const long long*)hi + i), (int64_t)__ldcs((const long long*)lo + i)};
  }
  __device__ __forceinline__ void copy_async(Key2* dst, int64_t i) const {
    __pipeline_memcpy_async(&dst->hi, hi + i, 8);
    __pipeline_memcpy_async(&dst->lo, lo + i, 8);
  }
};

// Each key's shape: queries a thread, and bytes of shared memory a block
// stages `a` in.
template <typename K>
struct Shape;
template <>
struct Shape<Key1> {
  using Cols = Cols1;
  static constexpr int kItems = 2;
  static constexpr int kWindowBytes = 8 * 1024;
};
template <>
struct Shape<Key2> {
  using Cols = Cols2;
  static constexpr int kItems = 4;
  static constexpr int kWindowBytes = 32 * 1024;
};

// Rows staged in shared memory: row i of `a` at win[i - base].
template <typename K>
struct SharedRows {
  const K* win;
  int64_t base;
  __device__ __forceinline__ K operator[](int64_t i) const { return win[i - base]; }
};

// -- the searches ---------------------------------------------------------------

// The reference's unrolled search over rows [lo, hi) of `a`, for every query
// of the thread at once (independent loads in flight): pos[k] is the
// insertion point of query k if it lies in [lo, hi]. With lo = 0, hi = n it
// is _xla_searchsorted(2) step for step.
template <bool RIGHT, int N, typename K, typename Rows>
__device__ __forceinline__ void search_rows(const Rows& a, int64_t lo, int64_t hi,
                                            const K (&q)[N], int64_t (&pos)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) pos[k] = lo;
  if (hi <= lo) return;
  for (int64_t cur = hi - lo; cur > 1;) {
    const int64_t half = cur >> 1;
#pragma unroll
    for (int k = 0; k < N; ++k)
      pos[k] = pred<RIGHT>(a[pos[k] + half - 1], q[k]) ? pos[k] + half : pos[k];
    cur -= half;
  }
#pragma unroll
  for (int k = 0; k < N; ++k) pos[k] += pred<RIGHT>(a[pos[k]], q[k]) ? 1 : 0;
}

// Insertion point of q in rows [lo, hi) of `a`, clamped into [lo, hi], by one
// warp: each level probes 32 evenly spaced rows of the candidate range (one
// a lane) and keeps the stretch between the last row that satisfies the
// predicate and the first that does not: 5 levels at n = 2^22.
template <bool RIGHT, typename K, typename Rows>
__device__ int64_t warp_search(const Rows& a, int64_t lo, int64_t hi, const K& q, int lane) {
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t i = lo + (int64_t)(lane + 1) * step - 1;  // the end of part `lane`
    const int64_t k = __popc(__ballot_sync(kFull, i < hi && pred<RIGHT>(a[i], q)));
    const int64_t next_hi = lo + (k + 1) * step - 1;
    lo += k * step;
    hi = next_hi < hi ? next_hi : hi;
  }
  const bool t = lo + lane < hi && pred<RIGHT>(a[lo + lane], q);
  return lo + __popc(__ballot_sync(kFull, t));
}

// Copy rows lo, lo + stride, ... of `a` into win[0, count): `lanes` threads,
// `rank` this one's index among them, every copy in flight at once. The
// caller synchronises the threads before reading win.
template <typename K, typename Cols>
__device__ __forceinline__ void stage(const Cols& a, int64_t lo, int64_t stride, int count,
                                      K* win, int lanes, int rank) {
  for (int i = rank; i < count; i += lanes) a.copy_async(win + i, lo + i * stride);
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// For each query k, the insertion point within rows [pos[k], hi[k]) of `a`
// (a few hundred rows at most): a kWays-way search, the warp_search of one
// thread, every probe of a level and of every query in flight at once, so
// the dependent steps are log_kWays of the rows, not log2.
template <bool RIGHT, int N, typename K, typename Rows>
__device__ __forceinline__ void search_between(const Rows& a, const int64_t (&hi)[N],
                                               const K (&q)[N], int64_t (&pos)[N]) {
  int64_t top[N];
#pragma unroll
  for (int k = 0; k < N; ++k) top[k] = hi[k];  // the insertion point lies in [pos, top]
  for (bool more = true; more;) {
    more = false;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (top[k] - pos[k] > kWays) {
        const int64_t step = (top[k] - pos[k] + kWays - 1) / kWays;
        int t = 0;
#pragma unroll
        for (int u = 1; u <= kWays; ++u) {
          const int64_t i = pos[k] + u * step - 1;
          t += i < top[k] && pred<RIGHT>(a[i], q[k]) ? 1 : 0;
        }
        const int64_t next = pos[k] + (t + 1) * step - 1;
        pos[k] += t * step;
        top[k] = next < top[k] ? next : top[k];
        more = more || top[k] - pos[k] > kWays;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int t = 0;
#pragma unroll
    for (int u = 0; u < kWays; ++u) t += pos[k] + u < top[k] && pred<RIGHT>(a[pos[k] + u], q[k]);
    pos[k] += t;
  }
}

template <typename K>
__host__ __device__ constexpr int window_rows() {
  return Shape<K>::kWindowBytes / (int)sizeof(K);
}

// -- the tile kernel --------------------------------------------------------------

template <typename K, bool RIGHT>
__global__ void __launch_bounds__(kThreads)
probe_tile_kernel(typename Shape<K>::Cols a, int64_t n, typename Shape<K>::Cols q, int64_t m,
                  int64_t* __restrict__ out) {
  constexpr int kItems = Shape<K>::kItems;
  constexpr int kSub = 32 * kItems;                  // queries a warp
  constexpr int64_t kTile = (int64_t)kWarps * kSub;  // queries a block
  constexpr int kWindow = window_rows<K>();          // rows a block stages
  extern __shared__ __align__(16) unsigned char smem[];
  K* win = reinterpret_cast<K*>(smem);
  __shared__ int64_t bound[4];  // lb(first), ub(first), lb(last), ub(last)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  const int64_t end = (m - base < kTile) ? m : base + kTile;
  const int64_t wbase = base + (int64_t)warp * kSub;  // the warp's sub-tile

  // 1. the tile's queries; rows past the end repeat the last query
  K v[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t j = wbase + k * 32 + lane;
    v[k] = q.stream(j < end ? j : end - 1);
  }
  const K first = q[base], last = q[end - 1];

  // 2. lb and ub of the first and the last query, one warp each (two when
  // they are equal: the others would repeat their searches)
  const bool one_key = equal(first, last);
  if (warp < (one_key ? 2 : 4)) {
    const K s = warp >= 2 ? last : first;
    const int64_t r = (warp & 1) ? warp_search<true>(a, 0, n, s, lane)
                                 : warp_search<false>(a, 0, n, s, lane);
    if (lane == 0) {
      bound[warp] = r;
      if (one_key) bound[warp + 2] = r;
    }
  }

  bool ordered = true;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t j = wbase + k * 32 + lane;
    // the predecessor: the lane to the left, or the last lane of the row
    // before, or (the warp's first query) a load
    const K up = shfl_up(v[k]);
    const K wrap = k > 0 ? shfl(v[k > 0 ? k - 1 : 0], 31) : v[k];
    const K prev = lane > 0 ? up : (k > 0 ? wrap : (j > base && j < end ? q[j - 1] : v[k]));
    if (j > base && j < end) ordered = ordered && !less(v[k], prev);
  }
  const bool sorted = __syncthreads_and(ordered);

  int64_t pos[kItems];
  if (!sorted) {
    // 5. an unsorted tile: the reference's loop over all of `a`
    search_rows<RIGHT>(a, 0, n, v, pos);
  } else {
    const int64_t r_first = bound[RIGHT ? 1 : 0], r_last = bound[RIGHT ? 3 : 2];
    const int64_t wlo = bound[1], whi = bound[2];
    if (!one_key) {  // block-uniform
      // 3./4. the block stages every stride-th row of the window: all of it
      // when it fits (stride 1), else an even sample of kWindow rows
      const int64_t w = whi - wlo;
      const int64_t stride = w <= kWindow ? 1 : (w + kWindow - 1) / kWindow;
      const int samples = (int)((w + stride - 1) / stride);
      stage(a, wlo, stride, samples, win, kThreads, tid);
      __syncthreads();
      // the samples before each query's insertion point, in shared memory
      int64_t c[kItems];
      search_rows<RIGHT>(SharedRows<K>{win, 0}, 0, samples, v, c);
      // then the stride - 1 rows between the two samples around it
      int64_t hi[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        pos[k] = c[k] == 0 ? wlo : wlo + (c[k] - 1) * stride + 1;
        hi[k] = c[k] == samples ? whi : wlo + c[k] * stride;
      }
      if (stride > 1) search_between<RIGHT>(a, hi, v, pos);
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (equal(v[k], first)) pos[k] = r_first;
      else if (equal(v[k], last)) pos[k] = r_last;
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t j = wbase + k * 32 + lane;
    if (j < end) out[j] = pos[k];
  }
}

// Launch the tile kernel for key K over m > 0 queries and n > 0 rows.
template <typename K>
cudaError_t launch_tiles(typename Shape<K>::Cols a, int64_t n,
                         typename Shape<K>::Cols q, int64_t m, int side, int64_t* out,
                         cudaStream_t st) {
  constexpr int64_t kTile = (int64_t)kThreads * Shape<K>::kItems;
  constexpr int bytes = window_rows<K>() * (int)sizeof(K);
  static_assert(bytes <= 46 * 1024, "past the 48 KB default a block must opt in");
  auto kernel = side ? probe_tile_kernel<K, true> : probe_tile_kernel<K, false>;
  const unsigned tiles = (unsigned)((m + kTile - 1) / kTile);
  kernel<<<tiles, kThreads, bytes, st>>>(a, n, q, m, out);
  return cudaGetLastError();
}

}  // namespace

// The tile kernel's shape for key `pair` (0: probe, 1: probe2): `what` 0
// gives the queries a thread, 1 the rows of `a` a block stages.
extern "C" int mz_probe_shape(int pair, int what) {
  const int items = pair ? Shape<Key2>::kItems : Shape<Key1>::kItems;
  const int window = pair ? window_rows<Key2>() : window_rows<Key1>();
  return what == 0 ? items : what == 1 ? window : -1;
}

// a[n] sorted ascending, q[m] -> out[m] insertion points in [0, n], all int64
// on CUDA device `device`. n > 0 and m > 0 (the caller returns early
// otherwise). side: 0 left, 1 right.
extern "C" int mz_probe(int device, const void* a, int64_t n, const void* q, int64_t m,
                        int side, void* out, void* stream) {
  mz::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  return (int)launch_tiles<Key1>(Cols1{(const int64_t*)a}, n, Cols1{(const int64_t*)q},
                                 m, side, (int64_t*)out, (cudaStream_t)stream);
}

// The same over (hi, lo) pairs compared lexicographically; `a` pair-sorted.
extern "C" int mz_probe2(int device, const void* a_hi, const void* a_lo, int64_t n,
                         const void* q_hi, const void* q_lo, int64_t m, int side, void* out,
                         void* stream) {
  mz::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  return (int)launch_tiles<Key2>(Cols2{(const int64_t*)a_hi, (const int64_t*)a_lo}, n,
                                 Cols2{(const int64_t*)q_hi, (const int64_t*)q_lo}, m, side,
                                 (int64_t*)out, (cudaStream_t)stream);
}
