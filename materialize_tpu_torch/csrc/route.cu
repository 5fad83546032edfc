// route_dest / bucket_rank: the two integer primitives of the mesh exchange.
//
// route_dest replaces materialize_tpu/ops/kernels/route.py::_pallas_route_dest:
// dest[i] = hash[i] mod n_dest as int32, the shared routing rule
// (parallel/routing.py::route_mod). The port carries u32 hashes as int64 in
// [0, 2^32), the kernel's precondition, so a 32-bit modulus is exact. Bound
// on the H100: bytes, one read of 8 B and one write of 4 B a row; one thread
// a row.
//
// bucket_rank replaces ::_pallas_bucket_rank: for int32 keys k[n] (the
// destinations in sorted order), rank[i] = i - max{ j <= i : j == 0 or
// k[j] != k[j-1] }, that is idx - cummax(run_start ? idx : -1), computed as
// written for every input, sorted or not. The TPU kernel scans one VMEM tile
// in log2(n) shift steps; here one launch reads the keys once, a single-pass
// max-scan with a decoupled look-back (run_sum.cu's scheme, mirrored):
//   1. each block takes a ticket from an atomic counter, and ticket t is tile
//      t: the tiles to a block's left have always started;
//   2. each warp loads its 32 * kItems rows as 16-byte vectors striped over
//      its lanes (coalesced), forms run_start ? i : -1 and max-scans it in
//      row order with shuffles; the warps' maxima combine in shared memory;
//   3. a value that is not -1 grows with i, so a tile that holds a run start
//      knows its inclusive prefix maximum at once, its largest run start.
//      Thread 0 publishes the tile's status word, state and value in one
//      32-bit store: 0 not published, kNone no run start and no prefix yet,
//      kInclusive + p the inclusive prefix maximum p (p < 2^31);
//   4. only rows before the tile's first run start need anything from the
//      left: the nearest run start there. If the tile's first row starts no
//      run, warp 0 looks back 32 * kLook tiles a step, skips kNone words,
//      waits while the nearest other word reads 0, and stops at the nearest
//      kInclusive + p. Tile 0 holds row 0, so the look-back ends. A tile
//      without a run start then publishes kInclusive + carry, so the later
//      tiles of one long run stop at it and no warp walks the run. Status
//      words lie kStride words (128 B) apart: packed into a few lines, the
//      waiting warps' reads queued at their L2 slices;
//   5. every row is written once: at once in a tile that does not look back,
//      else after the look-back.
// The ticket and status words are scratch of the call, zeroed by one memset
// on the call's stream, so concurrent calls never share them; a call of one
// tile needs neither (tile 0 never looks back): one launch, no memset. The
// caller sizes the scratch (ops/kernels/route.py::bucket_rank_scratch_words)
// and passes its size, which the entry point checks.
//
// Bound on the H100: bytes, a read of 4 B and a write of 4 B a row. At the
// exchange's sizes (2^14 to 2^19 rows) a call is far from it: its time is
// the memset, the launch, the ticket and, in a long run, the look-back's
// round trips to L2. The shape was settled by scripts/port_kernel_sweep.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kRouteThreads = 256;

// bucket_rank's shape
constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;  // blocks an SM must fit (caps the registers)
constexpr int kItems = 16;     // rows a thread, a multiple of 4
constexpr int kLook = 8;       // tiles a lane reads at each look-back step
constexpr int kStride = 32;    // 32-bit words from one status word (or the ticket) to the next
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone = 1, kInclusive = 2;

__global__ void route_kernel(const int64_t* __restrict__ h, int64_t n, int32_t nd,
                             int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = (int32_t)((uint32_t)h[i] % (uint32_t)nd);
}

// Status words are stored and loaded relaxed at device scope: a word carries
// its own value, and each load of a waiting lane reaches L2 again.
__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
  uint32_t s;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(s) : "l"(p) : "memory");
  return s;
}

__device__ __forceinline__ void store_status(uint32_t* p, uint32_t s) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(s) : "memory");
}

__device__ __forceinline__ int32_t max32(int32_t a, int32_t b) { return a > b ? a : b; }

// Row k of a lane whose warp starts at row w0: its group of 4 (a 16-byte
// vector) is g = k / 4, at rows w0 + (g * 32 + lane) * 4.
__device__ __forceinline__ int64_t row_of(int64_t w0, int lane, int k) {
  return w0 + (int64_t)((k / 4) * 32 + lane) * 4 + k % 4;
}

// A thread's ranks: r[k] is row k's nearest run start in the tile, or -1
// where it takes `carry`, the nearest one left of the tile. Vectors where
// `vec` (a whole tile, aligned arrays), else one row at a time.
__device__ __forceinline__ void store_rows(int32_t* __restrict__ out, int64_t w0, int lane,
                                           int64_t n, bool vec, const int32_t (&r)[kItems],
                                           int32_t carry) {
  int32_t y[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    y[k] = (int32_t)row_of(w0, lane, k) - (r[k] < 0 ? carry : r[k]);
#pragma unroll
  for (int g = 0; g < kItems / 4; ++g) {
    const int64_t i = row_of(w0, lane, 4 * g);
    if (vec) {
      *reinterpret_cast<int4*>(out + i) =
          make_int4(y[4 * g], y[4 * g + 1], y[4 * g + 2], y[4 * g + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (i + c < n) out[i + c] = y[4 * g + c];
    }
  }
}

// Warp 0 of tile p: the nearest run start left of the tile. Tile j's word is
// status[j * kStride]; a word that reads 0 is read again, any other is final.
__device__ int32_t look_back(const uint32_t* status, int64_t p, int lane) {
  for (int64_t j0 = p - 1;; j0 -= 32 * kLook) {
    uint32_t st[kLook];  // the lane's words, nearest first
#pragma unroll
    for (int u = 0; u < kLook; ++u) {
      const int64_t j = j0 - lane * kLook - u;
      st[u] = j >= 0 ? load_status(status + j * kStride) : kNone;
    }
    for (;;) {
      uint32_t near = kNone;  // the lane's nearest word that is not kNone
#pragma unroll
      for (int u = kLook - 1; u >= 0; --u)
        if (st[u] != kNone) near = st[u];
      const unsigned found = __ballot_sync(kFull, near != kNone);
      if (!found) break;  // no tile of this step holds a run start: further left
      const uint32_t w = __shfl_sync(kFull, near, __ffs(found) - 1);
      if (w >= kInclusive) return (int32_t)(w - kInclusive);
#pragma unroll
      for (int u = 0; u < kLook; ++u)  // the nearest is unpublished: read the zeros again
        if (st[u] == 0) st[u] = load_status(status + (j0 - lane * kLook - u) * kStride);
    }
  }
}

// words: the ticket, then a status word a tile, kStride words apart (zeroed);
// unused when nt == 1.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bucket_rank_kernel(const int32_t* __restrict__ key, int64_t n, int64_t nt,
                   uint32_t* __restrict__ words, int32_t* __restrict__ out) {
  __shared__ int32_t warp_max[kWarps];
  __shared__ int64_t tile;
  __shared__ int32_t carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) tile = nt > 1 ? (int64_t)atomicAdd(words, 1u) : 0;
  __syncthreads();
  const int64_t p = tile, t0 = p * kTile;
  const int64_t w0 = t0 + (int64_t)warp * 32 * kItems;  // the warp's first row
  const bool vec = t0 + kTile <= n && (((uintptr_t)key | (uintptr_t)out) & 15) == 0;
  uint32_t* status = words + kStride;

  int32_t x[kItems], r[kItems];
#pragma unroll
  for (int g = 0; g < kItems / 4; ++g) {
    const int64_t i = row_of(w0, lane, 4 * g);
    if (vec) {
      const int4 q = *reinterpret_cast<const int4*>(key + i);
      x[4 * g] = q.x, x[4 * g + 1] = q.y, x[4 * g + 2] = q.z, x[4 * g + 3] = q.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) x[4 * g + c] = i + c < n ? key[i + c] : 0;
    }
  }
  // r = run_start ? row : -1, then its inclusive max-scan in row order:
  // within each group of 4, over the lanes, over the groups, over the warps
  int32_t run = -1;  // the warp's maximum before group g
#pragma unroll
  for (int g = 0; g < kItems / 4; ++g) {
    // the key before the group: the previous lane's last, lane 31's last of
    // the previous group, or (the warp's first row) from memory
    int32_t prev = __shfl_up_sync(kFull, x[4 * g + 3], 1);
    const int32_t last = __shfl_sync(kFull, x[g > 0 ? 4 * g - 1 : 0], 31);
    if (lane == 0) prev = g > 0 ? last : w0 > 0 && w0 < n ? key[w0 - 1] : 0;
    int32_t m = -1;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t i = row_of(w0, lane, 4 * g + c);
      r[4 * g + c] = m = i < n && (i == 0 || x[4 * g + c] != prev) ? (int32_t)i : m;
      prev = x[4 * g + c];
    }
    int32_t incl = m;  // the maximum over this group's lanes up to this one
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl = max32(incl, y);
    }
    const int32_t up = __shfl_up_sync(kFull, incl, 1);
    const int32_t before = max32(run, lane ? up : -1);
#pragma unroll
    for (int c = 0; c < 4; ++c) r[4 * g + c] = max32(r[4 * g + c], before);
    run = max32(run, __shfl_sync(kFull, incl, 31));
  }
  if (lane == 0) warp_max[warp] = run;
  __syncthreads();
  int32_t agg = -1;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) r[k] = max32(r[k], agg);
    }
    agg = max32(agg, warp_max[w]);
  }
  if (tid == 0 && nt > 1)
    store_status(status + p * kStride, agg >= 0 ? kInclusive + (uint32_t)agg : kNone);
  // a tile whose first row starts a run needs nothing from its left; in any
  // other, the rows before its first run start (r of -1) take the carry
  if (p == 0 || key[t0] != key[t0 - 1]) {
    store_rows(out, w0, lane, n, vec, r, 0);
    return;
  }
  if (warp == 0) {
    const int32_t c = look_back(status, p, lane);
    if (lane == 0) {
      carry = c;
      if (agg < 0) store_status(status + p * kStride, kInclusive + (uint32_t)c);
    }
  }
  __syncthreads();
  store_rows(out, w0, lane, n, vec, r, carry);
}

}  // namespace

// hashes: int64[n], each in [0, 2^32); out: int32[n], on CUDA device `device`.
// Requires n > 0 and n_dest > 0.
extern "C" int mz_route_dest(int device, const void* hashes, int64_t n, int n_dest, void* out,
                             void* stream) {
  mz::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const unsigned blocks = (unsigned)((n + kRouteThreads - 1) / kRouteThreads);
  route_kernel<<<blocks, kRouteThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)hashes, n, (int32_t)n_dest, (int32_t*)out);
  return (int)cudaGetLastError();
}

// bucket_rank's shape: `what` 0 gives the rows of a tile, 1 the 32-bit words
// of scratch a tile (and the ticket) takes.
extern "C" int mz_bucket_rank_shape(int what) { return what ? kStride : kTile; }

// key_s, out: int32[n] on CUDA device `device`, 0 < n < 2^31. When n > kTile,
// `scratch` holds `words` 32-bit words, at least kStride * (1 + ceil(n /
// kTile)); else it is not read. One memset (none for one tile) and one
// launch on `stream`.
extern "C" int mz_bucket_rank(int device, const void* key_s, int64_t n, void* out,
                              void* scratch, int64_t words, void* stream) {
  const int64_t nt = (n + kTile - 1) / kTile, need = (1 + nt) * kStride;
  if (n <= 0 || n >= ((int64_t)1 << 31) || (nt > 1 && (scratch == nullptr || words < need)))
    return (int)cudaErrorInvalidValue;
  mz::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  cudaStream_t st = (cudaStream_t)stream;
  if (nt > 1) {
    const cudaError_t err = cudaMemsetAsync(scratch, 0, need * 4, st);
    if (err != cudaSuccess) return (int)err;
  }
  bucket_rank_kernel<<<(unsigned)nt, kThreads, 0, st>>>((const int32_t*)key_s, n, nt,
                                                        (uint32_t*)scratch, (int32_t*)out);
  return (int)cudaGetLastError();
}
