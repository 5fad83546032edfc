// run_sum: segmented sum by run over a canonically sorted batch.
//
// Replaces materialize_tpu/ops/kernels/segsum.py::_pallas_run_sum. For each
// integer column v of a call and the run-start flags rs, out[i] = sum of v
// over the run that starts at i if rs[i], else 0. Rows before the first run
// start belong to no run. Integer addition wraps and is associative, so any
// order of summation gives bit-identical results. The arithmetic runs on
// uint64 for every column, int32 and int64 alike: the low 32 bits of a
// wrapping 64-bit sum are the wrapping 32-bit sum, and the wrap is defined.
//
// Design: a backward segmented inclusive scan. With end[i] true where a run
// ends (i == n - 1 or rs[i + 1]),
//     s[i] = v[i] + (end[i] ? 0 : s[i + 1])
// so s at a run start is the run's total. The pair (sum, "holds a run end")
// under SegCombine is associative. One launch does every column (up to
// kMaxCols; more columns take one launch each such group) in one pass, a
// single-pass scan with decoupled look-back:
//   1. each block takes a ticket from an atomic counter; ticket t is tile
//      nt - 1 - t, so tiles start right to left and a tile's right
//      neighbours have always started (no block waits on one that cannot run);
//   2. the block reads the tile's flags once, then for each column scans the
//      tile in registers (kItems rows a thread, cub::BlockScan over the
//      threads, rows right to left) with nothing coming in from the right,
//      and writes out[] for every row: only the rows after the tile's last
//      run end depend on the tiles to the right, and of those at most one,
//      the row just after that end, starts a run;
//   3. thread 0 publishes the tile's aggregate of every column under one
//      status word (the values, then the status with release semantics;
//      readers load status words relaxed, all at once, then fence): 1 =
//      aggregate, 2 = inclusive. A tile
//      that holds a run end publishes its inclusive value at once, since
//      nothing to its right changes it;
//   4. if the tile's last row ends no run, warp 0 looks back: 32 tiles to
//      the right at a step, one a lane, it waits until each has published,
//      then sums the aggregates up to the first tile that is inclusive. The trailing padding is one run of millions of rows: its
//      tiles chain through each other's inclusive values, and no thread
//      walks a run serially. In such a run the first inclusive tile to the
//      right (the frontier) is what every tile waits for, and it moves by at
//      most one step's width a step: wide steps keep it ahead of the scan;
//   5. thread 0 publishes the tile's inclusive value, and warp 0 rewrites
//      the one row that needed the incoming sum.
// The status words and the ticket counter are scratch of the call (zeroed by
// one memset on the call's stream), so calls on concurrent streams never
// share them.
//
// Bound on the H100: bytes, the least traffic being one read of rs and of
// every column and one write of every output; this kernel adds a few bytes a
// tile of status and values, and reads rs twice (once shifted by a row, the
// second time from L1/L2). The shape below was settled by a sweep on the
// card at the main path's largest call (PERF.md): fewer, larger tiles keep
// fewer blocks waiting on the look-back.

#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <stdint.h>

#include <atomic>
#include <cub/block/block_scan.cuh>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;  // blocks an SM must fit (caps the registers)
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;  // rows a thread
constexpr int kBufRows = 32 * (kItems + 1);  // a warp's transposing buffer, padded
constexpr int kSmemBytes = 2 * kWarps * kBufRows * 8;  // two buffers a warp
constexpr int kTile = kThreads * kItems;
constexpr int kMaxCols = 8;  // columns a launch
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kAggregate = 1, kInclusive = 2;

struct Seg {
  uint64_t v;  // sum from the segment's first row up to its first run end
  int f;       // 1 if the segment holds a run end
};

// `right` is the suffix already scanned (larger indices); `left` is the new
// segment to its left.
struct SegCombine {
  __device__ __forceinline__ Seg operator()(const Seg& right, const Seg& left) const {
    return Seg{left.f ? left.v : left.v + right.v, left.f | right.f};
  }
};

struct Cols {
  const void* in[kMaxCols];
  void* out[kMaxCols];
  int width[kMaxCols];  // bytes: 4 or 8
  int k;
};

using Scan = cub::BlockScan<Seg, kThreads>;

// The thread with block rank t owns chunk kThreads - 1 - t of the tile
// (kItems consecutive rows), so cub's forward scan over the threads runs
// right to left over the rows. A warp owns 32 consecutive chunks and loads
// and stores them striped (coalesced), through shared memory.
__device__ __forceinline__ int chunk_of(int tid) { return kThreads - 1 - tid; }

// The first row of warp `warp`'s rows: its lanes' chunks, highest rank first.
__device__ __forceinline__ int64_t warp_rows(int64_t t0, int warp) {
  return t0 + (int64_t)chunk_of(warp * 32 + 31) * kItems;
}

// The transposing buffer of a warp: row e of its 32 * kItems rows at slot
// (e / kItems) * (kItems + 1) + e % kItems (padded: no bank conflicts).
__device__ __forceinline__ int slot(int e) { return (e / kItems) * (kItems + 1) + e % kItems; }

// Start copying rows [w0, w0 + 32 * kItems) of a column into the warp's
// buffer (cp.async, coalesced, no registers); rows at or past n read 0.
template <typename T>
__device__ __forceinline__ void fetch_rows(const T* __restrict__ src, int64_t w0, int64_t n,
                                           uint64_t* buf, int lane) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int e = j * 32 + lane;
    const int64_t i = w0 + e;
    if (i < n) __pipeline_memcpy_async(buf + slot(e), src + i, sizeof(T));
    else buf[slot(e)] = 0;
  }
  __pipeline_commit();
}

__device__ __forceinline__ void fetch(const void* src, int width, int64_t w0, int64_t n,
                                      uint64_t* buf, int lane) {
  if (width == 8) fetch_rows((const uint64_t*)src, w0, n, buf, lane);
  else fetch_rows((const uint32_t*)src, w0, n, buf, lane);
}

// The lane's chunk (chunk 31 - lane of the warp's rows) out of the buffer.
template <typename T>
__device__ __forceinline__ void read_chunk(const uint64_t* buf, int lane, uint64_t (&v)[kItems]) {
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    v[k] = *reinterpret_cast<const T*>(buf + (31 - lane) * (kItems + 1) + k);
}

template <typename T>
__device__ __forceinline__ void store_chunks(T* __restrict__ dst, int64_t w0, int64_t n,
                                             const uint64_t (&v)[kItems], uint64_t* buf,
                                             int lane) {
#pragma unroll
  for (int k = 0; k < kItems; ++k) buf[(31 - lane) * (kItems + 1) + k] = v[k];
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int e = j * 32 + lane;
    const int64_t i = w0 + e;
    if (i < n) dst[i] = (T)buf[slot(e)];
  }
  __syncwarp();
}

// The status word of a tile: written with release (the values written
// before it are seen by whoever reads it and then fences), read relaxed, so
// that a lane's loads of several status words are in flight at once.
__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
  uint32_t s;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(s) : "l"(p) : "memory");
  return s;
}

__device__ __forceinline__ void fence_acquire() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void store_status(uint32_t* p, uint32_t s) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(s) : "memory");
}

__device__ __forceinline__ uint64_t warp_sum(uint64_t x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// One column's scan of the tile, its rows already in the warp's buffer:
// the tile-local scan (nothing coming in from the right), v[] becoming the
// thread's rows of out[]; s at row `open` (tile-relative) into *open_s.
// Returns the tile's aggregate.
template <typename T>
__device__ __forceinline__ Seg column_scan(uint64_t (&v)[kItems], const bool (&start)[kItems],
                                           const bool (&end)[kItems], int open,
                                           uint64_t* open_s, Scan::TempStorage& tmp,
                                           const uint64_t* buf) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int chunk = chunk_of(tid);
  read_chunk<T>(buf, lane, v);
  Seg mine{0, 0};
#pragma unroll
  for (int k = kItems - 1; k >= 0; --k) {
    mine.v = end[k] ? v[k] : v[k] + mine.v;
    mine.f |= end[k] ? 1 : 0;
  }
  Seg carry, total;
  Scan(tmp).ExclusiveScan(mine, carry, Seg{0, 0}, SegCombine(), total);
  uint64_t right = tid == 0 ? 0 : carry.v;  // s at the next chunk's first row
#pragma unroll
  for (int k = kItems - 1; k >= 0; --k) {
    right = end[k] ? v[k] : v[k] + right;
    if (chunk * kItems + k == open) *open_s = right;
    v[k] = start[k] ? right : 0;
  }
  return total;
}

__device__ __forceinline__ void store(void* out, int width, int64_t w0, int64_t n,
                                      const uint64_t (&v)[kItems], uint64_t* buf, int lane) {
  __syncwarp();  // every lane has read its chunk before the buffer is reused
  if (width == 8) store_chunks((uint64_t*)out, w0, n, v, buf, lane);
  else store_chunks((uint32_t*)out, w0, n, v, buf, lane);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
run_sum_kernel(Cols cols, const uint8_t* __restrict__ rs, int64_t n, int64_t nt,
               uint32_t* __restrict__ ticket, uint32_t* __restrict__ status,
               uint64_t* __restrict__ vals) {
  __shared__ Scan::TempStorage tmp;
  extern __shared__ uint64_t bufs[];  // column c in the warp's buffer c & 1
  __shared__ uint64_t agg[kMaxCols], open_s[kMaxCols];
  __shared__ int64_t tile;
  __shared__ int last_end, agg_f;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    tile = nt - 1 - (int64_t)atomicAdd(ticket, 1u);
    last_end = -1;
  }
  __syncthreads();
  const int64_t p = tile;
  const int64_t t0 = p * kTile;
  const int64_t w0 = warp_rows(t0, warp);
  uint64_t* buf[2] = {bufs + warp * kBufRows, bufs + (kWarps + warp) * kBufRows};
  fetch(cols.in[0], cols.width[0], w0, n, buf[0], lane);

  // the tile's flags, read once for every column
  const int chunk = chunk_of(tid);
  bool start[kItems], end[kItems];
  int my_last = -1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = t0 + (int64_t)chunk * kItems + k;
    start[k] = i < n && rs[i];
    end[k] = i + 1 >= n || rs[i + 1];  // rows at or past n end nothing that matters
    if (end[k] && i < n) my_last = chunk * kItems + k;
  }
  if (my_last >= 0) atomicMax(&last_end, my_last);
  __syncthreads();
  const int open = last_end + 1;  // the one row that may need the incoming sum

  for (int c = 0; c < cols.k; ++c) {
    if (c > 0) __syncthreads();  // tmp is reused
    // the next column's rows are in flight while this one is scanned
    if (c + 1 < cols.k) {
      fetch(cols.in[c + 1], cols.width[c + 1], w0, n, buf[(c + 1) & 1], lane);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();
    uint64_t* b = buf[c & 1];
    uint64_t v[kItems];
    const Seg total = cols.width[c] == 8
                          ? column_scan<uint64_t>(v, start, end, open, &open_s[c], tmp, b)
                          : column_scan<uint32_t>(v, start, end, open, &open_s[c], tmp, b);
    if (tid == 0) agg[c] = total.v;
    if (c + 1 < cols.k) {
      store(cols.out[c], cols.width[c], w0, n, v, b, lane);
      continue;
    }
    // the last column: thread 0 holds every column's aggregate, in agg[],
    // and publishes them (the aggregate, or when the tile holds a run end the
    // inclusive value) before the tile's last stores, so that the tiles to
    // the left see it sooner
    if (tid == 0) {
      const int k = cols.k;
      uint64_t* mine = vals + p * 2 * k + (total.f ? k : 0);
      for (int j = 0; j < k; ++j) mine[j] = agg[j];
      store_status(status + p, total.f ? kInclusive : kAggregate);
      agg_f = total.f;
    }
    store(cols.out[c], cols.width[c], w0, n, v, b, lane);
  }
  __syncthreads();
  if (warp != 0) return;

  // tile j's values: aggregates at vals[j * 2k + c], inclusive at vals[j * 2k + k + c]
  const int k = cols.k;
  const bool holds_end = agg_f != 0;
  const int64_t last_row = (t0 + kTile < n ? t0 + kTile : n) - 1;
  if (t0 + last_end == last_row) return;  // the tile's last row ends a run

  // look back: the sum of the tiles to the right, up to the first inclusive
  // one, 32 tiles a step (one a lane)
  uint64_t in[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) in[c] = 0;
  for (int64_t j0 = p + 1;; j0 += 32) {
    const int64_t j = j0 + lane;  // this lane's tile
    // past the last tile: nothing, and stop
    uint32_t st = j < nt ? load_status(status + j) : kInclusive;
    while (st == 0) st = load_status(status + j);
    fence_acquire();  // the values below are read after their status
    const unsigned stop = __ballot_sync(kFull, st == kInclusive);
    const int at = stop ? __ffs(stop) - 1 : 32;  // the lane that holds the first one
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c < k) {
        const uint64_t x = lane <= at && j < nt
                               ? __ldcg((const unsigned long long*)vals + j * 2 * k +
                                        (st == kInclusive ? k : 0) + c)
                               : 0;
        in[c] += warp_sum(x);
      }
    }
    if (stop) break;
  }

  if (!holds_end && lane == 0) {
    uint64_t* mine = vals + p * 2 * k + k;
    for (int c = 0; c < k; ++c) mine[c] = agg[c] + in[c];
    store_status(status + p, kInclusive);
  }
  // the row after the tile's last run end, if it lies in the tile and starts a run
  const int64_t r = t0 + open;
  if (r <= last_row && rs[r]) {
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c < k && lane == c) {
        const uint64_t x = open_s[c] + in[c];
        if (cols.width[c] == 8) ((uint64_t*)cols.out[c])[r] = x;
        else ((uint32_t*)cols.out[c])[r] = (uint32_t)x;
      }
    }
  }
}

inline int64_t tiles_for(int64_t n) { return (n + kTile - 1) / kTile; }
inline int64_t groups_for(int k) { return (k + kMaxCols - 1) / kMaxCols; }
// Scratch: per launch group a ticket and nt status words (zeroed), then per
// column nt aggregates and nt inclusive values.
inline int64_t head_bytes(int64_t n, int k) {
  return ((groups_for(k) * (1 + tiles_for(n)) * 4) + 15) & ~(int64_t)15;
}

}  // namespace

// The kernel's shape: `what` 0 gives the rows of a tile, 1 the columns a
// launch takes.
extern "C" int mz_run_sum_shape(int what) { return what ? kMaxCols : kTile; }

// Bytes of scratch that mz_run_sum needs for k columns of n rows.
extern "C" int64_t mz_run_sum_scratch_bytes(int64_t n, int k) {
  return n > 0 && k > 0 ? head_bytes(n, k) + (int64_t)k * 2 * tiles_for(n) * 8 : 0;
}

// run_start: uint8/bool[n]; cols[3k]: the k columns' pointers, then their
// outputs' pointers, then their element bytes (4: int32, 8: int64), all of n
// rows on CUDA device `device`. Requires n > 0, k > 0 and scratch of
// mz_run_sum_scratch_bytes(n, k). One memset of the scratch's head and one
// launch for each kMaxCols columns, on `stream`.
extern "C" int mz_run_sum(int device, const void* run_start, const int64_t* cols, int k,
                          int64_t n, void* scratch, void* stream) {
  if (k <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  for (int c = 0; c < k; ++c)
    if (cols[2 * k + c] != 4 && cols[2 * k + c] != 8) return (int)cudaErrorInvalidValue;
  mz::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t nt = tiles_for(n);
  uint32_t* head = (uint32_t*)scratch;
  uint64_t* vals = (uint64_t*)((char*)scratch + head_bytes(n, k));
  cudaError_t err;
  if (kSmemBytes > 40 * 1024) {  // near the 48 KB default (static bytes too): opt in, once per device
    static std::atomic<uint64_t> allowed{0};
    const uint64_t bit = 1ull << (device & 63);
    if (!(allowed.load(std::memory_order_relaxed) & bit)) {
      err = cudaFuncSetAttribute(run_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBytes);
      if (err != cudaSuccess) return (int)err;
      allowed.fetch_or(bit);
    }
  }
  err = cudaMemsetAsync(head, 0, head_bytes(n, k), st);
  if (err != cudaSuccess) return (int)err;
  for (int c0 = 0, g = 0; c0 < k; c0 += kMaxCols, ++g) {
    Cols group;
    group.k = k - c0 < kMaxCols ? k - c0 : kMaxCols;
    for (int c = 0; c < group.k; ++c) {
      group.in[c] = (const void*)cols[c0 + c];
      group.out[c] = (void*)cols[k + c0 + c];
      group.width[c] = (int)cols[2 * k + c0 + c];
    }
    uint32_t* ticket = head + g * (1 + nt);
    run_sum_kernel<<<(unsigned)nt, kThreads, kSmemBytes, st>>>(
        group, (const uint8_t*)run_start, n, nt, ticket, ticket + 1,
        vals + (int64_t)c0 * 2 * nt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
