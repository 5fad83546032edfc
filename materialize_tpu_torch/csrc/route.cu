// route_dest / bucket_rank: the two integer primitives of the mesh exchange.
//
// route_dest replaces materialize_tpu/ops/kernels/route.py::_pallas_route_dest:
// dest[i] = hash[i] mod n_dest as int32, the shared routing rule
// (parallel/routing.py::route_mod). The port carries u32 hashes as int64 in
// [0, 2^32), the kernel's precondition, so a 32-bit modulus is exact. Bound
// on the H100: bytes, one read of 8 B and one write of 4 B a row; one thread
// a row.
//
// bucket_rank replaces ::_pallas_bucket_rank: for keys k[n] (the destinations
// in sorted order), rank[i] = i - max{ j <= i : j == 0 or k[j] != k[j-1] }, that
// is idx - cummax(run_start ? idx : -1). It is computed as written for every
// input, sorted or not. The TPU kernel scans one VMEM tile in log2(n) shift
// steps; on Hopper blocks run in any order, so the inclusive max-scan is cut
// into tiles of kTile rows, as run_sum.cu cuts its scan:
//   1. tile_max: each block reduces its tile's values (cub::BlockReduce, max);
//   2. the same scan, recursively, over the per-tile maxima, in place, until
//      one tile remains: it yields the inclusive max of every tile prefix;
//   3. apply_tile: each block scans its tile (cub::BlockScan, max), takes the
//      larger of that and the previous tile's prefix maximum, and writes the
//      rank (top level) or the scanned maximum (inner levels).
// Max is associative and exact, so any order gives the same integers. Bound
// on the H100: bytes, one read of 4 B and one write of 4 B a row; this
// version reads the keys twice (steps 1 and 3), 12 B a row.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int64_t kTile = (int64_t)kThreads * kItems;

__global__ void route_kernel(const int64_t* __restrict__ h, int64_t n, int32_t nd,
                             int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = (int32_t)((uint32_t)h[i] % (uint32_t)nd);
}

struct MaxOp {
  __device__ __forceinline__ int32_t operator()(int32_t a, int32_t b) const {
    return a > b ? a : b;
  }
};

// TOP: the value of row i is (run start ? i : -1) over keys `in`.
// !TOP: the value of row i is in[i] (a per-tile maximum of the level below).
template <bool TOP>
__device__ __forceinline__ void load_values(const int32_t* __restrict__ in, int64_t n,
                                            int64_t first, int32_t (&v)[kItems]) {
  int32_t prev = 0;
  if (TOP && first > 0 && first < n) prev = in[first - 1];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = first + k;
    if (i < n) {
      const int32_t x = in[i];
      if (TOP) {
        v[k] = (i == 0 || x != prev) ? (int32_t)i : -1;
        prev = x;
      } else {
        v[k] = x;
      }
    } else {
      v[k] = -1;
    }
  }
}

template <bool TOP>
__global__ void tile_max(const int32_t* __restrict__ in, int64_t n, int32_t* __restrict__ tiles) {
  using Reduce = cub::BlockReduce<int32_t, kThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  const int64_t first = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  int32_t v[kItems];
  load_values<TOP>(in, n, first, v);
  int32_t m = v[0];
#pragma unroll
  for (int k = 1; k < kItems; ++k) m = v[k] > m ? v[k] : m;
  const int32_t total = Reduce(tmp).Reduce(m, MaxOp());
  if (threadIdx.x == 0) tiles[blockIdx.x] = total;
}

// `prefix` holds the inclusive max over tiles 0..t for every tile t (null
// when there is one tile). Safe in place (in == out): a block reads only its
// own tile, and every thread has read its rows before the block scan ends.
template <bool TOP>
__global__ void apply_tile(const int32_t* in, int64_t n, const int32_t* __restrict__ prefix,
                           int32_t* out) {
  using Scan = cub::BlockScan<int32_t, kThreads>;
  __shared__ typename Scan::TempStorage tmp;
  const int64_t first = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  int32_t v[kItems];
  load_values<TOP>(in, n, first, v);
  int32_t m = v[0];
#pragma unroll
  for (int k = 1; k < kItems; ++k) m = v[k] > m ? v[k] : m;
  int32_t carry;
  Scan(tmp).ExclusiveScan(m, carry, (int32_t)-1, MaxOp());
  if (prefix != nullptr && blockIdx.x > 0) {
    const int32_t p = prefix[blockIdx.x - 1];
    carry = p > carry ? p : carry;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = first + k;
    carry = v[k] > carry ? v[k] : carry;
    if (i < n) out[i] = TOP ? (int32_t)(i - carry) : carry;
  }
}

inline int64_t tiles_for(int64_t n) { return (n + kTile - 1) / kTile; }
inline int64_t align16(int64_t b) { return (b + 15) & ~(int64_t)15; }

int64_t level_bytes(int64_t n) {
  const int64_t nt = tiles_for(n);
  if (nt <= 1) return 0;
  return align16(nt * 4) + level_bytes(nt);
}

template <bool TOP>
cudaError_t max_scan(const int32_t* in, int64_t n, int32_t* out, char* scratch, cudaStream_t st) {
  const int64_t nt = tiles_for(n);
  int32_t* tiles = nullptr;
  if (nt > 1) {
    tiles = (int32_t*)scratch;
    tile_max<TOP><<<(unsigned)nt, kThreads, 0, st>>>(in, n, tiles);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = max_scan<false>(tiles, nt, tiles, scratch + align16(nt * 4), st);
    if (err != cudaSuccess) return err;
  }
  apply_tile<TOP><<<(unsigned)nt, kThreads, 0, st>>>(in, n, tiles, out);
  return cudaGetLastError();
}

}  // namespace

// hashes: int64[n], each in [0, 2^32); out: int32[n]. Requires n > 0 and n_dest > 0.
extern "C" int mz_route_dest(const void* hashes, int64_t n, int n_dest, void* out, void* stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  route_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>((const int64_t*)hashes, n,
                                                              (int32_t)n_dest, (int32_t*)out);
  return (int)cudaGetLastError();
}

// Bytes of scratch that mz_bucket_rank needs for n rows.
extern "C" int64_t mz_bucket_rank_scratch_bytes(int64_t n) { return n > 0 ? level_bytes(n) : 0; }

// key_s: int32[n]; out: int32[n]. Requires 0 < n < 2^31 and scratch of
// mz_bucket_rank_scratch_bytes(n).
extern "C" int mz_bucket_rank(const void* key_s, int64_t n, void* out, void* scratch,
                              void* stream) {
  return (int)max_scan<true>((const int32_t*)key_s, n, (int32_t*)out, (char*)scratch,
                             (cudaStream_t)stream);
}
