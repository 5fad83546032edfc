// probe / probe2: batched fixed-depth binary search on the GPU.
//
// Replaces materialize_tpu/ops/kernels/probe.py::_pallas_searchsorted (probe)
// and ::_pallas_searchsorted2 (probe2). Both run the same unrolled loop as the
// JAX reference (_xla_searchsorted / _xla_searchsorted2): ceil(log2 n) + 1
// compare/select steps whose count depends only on n, so the warp never
// diverges. One thread per query.
//
// Bound on the H100: bytes and latency. Each query reads one 8-byte key and
// writes one 8-byte position; the sorted array is read at log2(n) dependent
// addresses per query. The top levels of the implicit search tree are shared
// by every query and stay in L2 (and L1, through __ldg); the bottom levels are
// one dependent global load each. Staging the upper tree levels in shared
// memory is left to a later change.
//
// Every column is int64 here: the port carries u32 hashes as int64 in
// [0, 2^32), and the join also searches its int64 prefix sum of match counts.

#include <cuda_runtime.h>
#include <stdint.h>

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

template <bool RIGHT>
__global__ void probe2_kernel(const int64_t* __restrict__ ah, const int64_t* __restrict__ al,
                              int64_t n, const int64_t* __restrict__ qh,
                              const int64_t* __restrict__ ql, int64_t m,
                              int64_t* __restrict__ out) {
  int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int64_t qhv = qh[j], qlv = ql[j];
  int64_t pos = 0;
  for (int64_t cur = n; cur > 1;) {
    const int64_t half = cur >> 1;
    const int64_t mid = pos + half - 1;
    pos = pred2<RIGHT>(__ldg(ah + mid), __ldg(al + mid), qhv, qlv) ? pos + half : pos;
    cur -= half;
  }
  out[j] = pos + (pred2<RIGHT>(__ldg(ah + pos), __ldg(al + pos), qhv, qlv) ? 1 : 0);
}

inline unsigned blocks_for(int64_t m) { return (unsigned)((m + kThreads - 1) / kThreads); }

}  // namespace

// a[n] sorted ascending, q[m] -> out[m] insertion points in [0, n].
// n > 0 and m > 0 (the caller returns early otherwise). side: 0 left, 1 right.
extern "C" int mz_probe(const void* a, int64_t n, const void* q, int64_t m, int side,
                        void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (side)
    probe_kernel<true><<<blocks_for(m), kThreads, 0, st>>>(
        (const int64_t*)a, n, (const int64_t*)q, m, (int64_t*)out);
  else
    probe_kernel<false><<<blocks_for(m), kThreads, 0, st>>>(
        (const int64_t*)a, n, (const int64_t*)q, m, (int64_t*)out);
  return (int)cudaGetLastError();
}

// The same search over (hi, lo) pairs compared lexicographically.
extern "C" int mz_probe2(const void* a_hi, const void* a_lo, int64_t n, const void* q_hi,
                         const void* q_lo, int64_t m, int side, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (side)
    probe2_kernel<true><<<blocks_for(m), kThreads, 0, st>>>(
        (const int64_t*)a_hi, (const int64_t*)a_lo, n, (const int64_t*)q_hi,
        (const int64_t*)q_lo, m, (int64_t*)out);
  else
    probe2_kernel<false><<<blocks_for(m), kThreads, 0, st>>>(
        (const int64_t*)a_hi, (const int64_t*)a_lo, n, (const int64_t*)q_hi,
        (const int64_t*)q_lo, m, (int64_t*)out);
  return (int)cudaGetLastError();
}
