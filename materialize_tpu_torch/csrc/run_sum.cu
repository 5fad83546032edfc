// run_sum: segmented sum by run over a canonically sorted batch.
//
// Replaces materialize_tpu/ops/kernels/segsum.py::_pallas_run_sum. For one
// integer column v and run-start flags rs, out[i] = sum of v over the run
// that starts at i if rs[i], else 0. Rows before the first run start belong
// to no run. Integer addition wraps and is associative, so any order of
// summation gives bit-identical results; the arithmetic runs on unsigned
// types so the wrap is defined.
//
// Design: a backward segmented inclusive scan. With end[i] true where a run
// ends (i == n - 1 or rs[i + 1]),
//     s[i] = v[i] + (end[i] ? 0 : s[i + 1])
// so s at a run start is the run's total. The pair (sum, "contains an end")
// under the combine below is associative, which gives three launches a level:
//   1. scan_tile: each block scans a tile of kTile rows right to left (each
//      thread its kItems rows in registers, cub::BlockScan across threads)
//      and writes the tile-local s, plus per tile: s at the tile start,
//      whether the tile holds a run end, and the offset of its last run end.
//   2. the same scan over the per-tile pairs, recursively, until one tile
//      remains: it yields the full s at every tile start.
//   3. fix_tile: a row after its tile's last run end continues into the next
//      tile, so it adds the full s at the next tile's start; the top level
//      then zeroes every row that is not a run start.
// Trailing padding is one run of up to millions of rows; no thread walks a
// run serially.
//
// Bound on the H100: bytes. The least traffic is one read of v and rs and one
// write of out; this version also writes the tile-local s and reads it back
// (about 2x the least bytes for 8-byte columns). A decoupled look-back scan
// in one pass is left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int64_t kTile = (int64_t)kThreads * kItems;

template <typename T>
struct Seg {
  T v;    // sum from the segment's first row up to its first run end
  int f;  // 1 if the segment holds a run end
};

// `right` is the suffix already scanned (larger indices); `left` is the new
// segment to its left.
template <typename T>
struct SegCombine {
  __device__ __forceinline__ Seg<T> operator()(const Seg<T>& right, const Seg<T>& left) const {
    Seg<T> r;
    r.v = left.f ? left.v : (T)(left.v + right.v);
    r.f = left.f | right.f;
    return r;
  }
};

// TOP: flags are run starts (bool/uint8) and end[i] = i == n-1 || rs[i+1].
// !TOP: flags are end flags directly.
template <typename T, bool TOP>
__global__ void scan_tile(const T* __restrict__ v, const uint8_t* __restrict__ flags, int64_t n,
                          T* __restrict__ s, T* __restrict__ tile_s, uint8_t* __restrict__ tile_f,
                          int32_t* __restrict__ tile_last) {
  using Scan = cub::BlockScan<Seg<T>, kThreads>;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ int32_t last_end;
  if (threadIdx.x == 0) last_end = -1;

  const int64_t base = (int64_t)blockIdx.x * kTile;
  // thread 0 owns the rightmost chunk, so the forward block scan runs right to left
  const int chunk = kThreads - 1 - (int)threadIdx.x;
  const int64_t first = base + (int64_t)chunk * kItems;

  T val[kItems];
  bool end[kItems];
  int my_last = -1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = first + k;
    if (i < n) {
      val[k] = v[i];
      if (TOP)
        end[k] = (i == n - 1) || flags[i + 1];
      else
        end[k] = (i == n - 1) || flags[i];
    } else {
      val[k] = 0;
      end[k] = true;
    }
    if (end[k] && i < n) my_last = chunk * kItems + k;
  }
  // this chunk's own pair
  Seg<T> mine;
  mine.v = 0;
  mine.f = 0;
#pragma unroll
  for (int k = kItems - 1; k >= 0; --k) {
    mine.v = end[k] ? val[k] : (T)(val[k] + mine.v);
    mine.f |= end[k] ? 1 : 0;
  }
  Seg<T> identity;
  identity.v = 0;
  identity.f = 0;
  Seg<T> carry, total;
  __syncthreads();  // last_end initialised
  if (my_last >= 0) atomicMax(&last_end, my_last);
  Scan(tmp).ExclusiveScan(mine, carry, identity, SegCombine<T>(), total);

  T right = carry.v;  // tile-local s at the next chunk's first row
#pragma unroll
  for (int k = kItems - 1; k >= 0; --k) {
    right = end[k] ? val[k] : (T)(val[k] + right);
    const int64_t i = first + k;
    if (i < n) s[i] = right;
  }
  __syncthreads();  // last_end complete
  if (threadIdx.x == 0) {
    tile_s[blockIdx.x] = total.v;
    tile_f[blockIdx.x] = (uint8_t)total.f;
    tile_last[blockIdx.x] = last_end;
  }
}

template <typename T, bool TOP>
__global__ void fix_tile(T* __restrict__ s, const uint8_t* __restrict__ run_start, int64_t n,
                         const T* __restrict__ tile_s_full, const int32_t* __restrict__ tile_last,
                         int64_t n_tiles) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t tile = i / kTile;
  T x = s[i];
  if (tile + 1 < n_tiles && (int32_t)(i - tile * kTile) > tile_last[tile])
    x = (T)(x + tile_s_full[tile + 1]);
  if (TOP) x = run_start[i] ? x : (T)0;
  s[i] = x;
}

inline int64_t tiles_for(int64_t n) { return (n + kTile - 1) / kTile; }
inline int64_t align16(int64_t b) { return (b + 15) & ~(int64_t)15; }

int64_t level_bytes(int64_t n, int elem) {
  const int64_t nt = tiles_for(n);
  int64_t b = align16(nt * elem) + align16(nt) + align16(nt * 4);
  if (nt > 1) b += level_bytes(nt, elem);
  return b;
}

// Scans v[n] (flags as TOP says) into s[n]. Runs in place when v == s.
template <typename T, bool TOP>
cudaError_t seg_scan(const T* v, const uint8_t* flags, int64_t n, T* s, char* scratch,
                     cudaStream_t st) {
  const int64_t nt = tiles_for(n);
  T* tile_s = (T*)scratch;
  uint8_t* tile_f = (uint8_t*)(scratch + align16(nt * sizeof(T)));
  int32_t* tile_last = (int32_t*)(scratch + align16(nt * sizeof(T)) + align16(nt));
  char* rest = scratch + align16(nt * sizeof(T)) + align16(nt) + align16(nt * 4);

  scan_tile<T, TOP><<<(unsigned)nt, kThreads, 0, st>>>(v, flags, n, s, tile_s, tile_f, tile_last);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (nt > 1) {
    err = seg_scan<T, false>(tile_s, tile_f, nt, tile_s, rest, st);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  fix_tile<T, TOP><<<blocks, kThreads, 0, st>>>(s, flags, n, tile_s, tile_last, nt);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch that mz_run_sum needs for n rows of elem_bytes each.
extern "C" int64_t mz_run_sum_scratch_bytes(int64_t n, int elem_bytes) {
  return n > 0 ? level_bytes(n, elem_bytes) : 0;
}

// run_start: uint8/bool[n]; col, out: [n] of elem_bytes (4: int32, 8: int64),
// on CUDA device `device`. Requires n > 0 and scratch of
// mz_run_sum_scratch_bytes(n, elem_bytes).
extern "C" int mz_run_sum(int device, const void* run_start, const void* col, int64_t n,
                          int elem_bytes, void* out, void* scratch, void* stream) {
  mz::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* rs = (const uint8_t*)run_start;
  switch (elem_bytes) {
    case 4:
      return (int)seg_scan<uint32_t, true>((const uint32_t*)col, rs, n, (uint32_t*)out,
                                           (char*)scratch, st);
    case 8:
      return (int)seg_scan<uint64_t, true>((const uint64_t*)col, rs, n, (uint64_t*)out,
                                           (char*)scratch, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
