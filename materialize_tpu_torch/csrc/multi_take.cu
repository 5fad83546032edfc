// multi_take: gather k same-width columns at one index vector, clip mode.
//
// Replaces materialize_tpu/ops/kernels/permute.py::_pallas_multi_take (with
// its _take_group_kernel): out[c][j] = in[c][clamp(idx[j], 0, n - 1)] for
// every column c of one group. The wrapper groups columns by element width,
// so bool travels as a 1-byte integer, exactly as the reference moves it as
// int8, and every dtype of one width shares a launch: a gather moves bits and
// never transforms them.
//
// Bound on the H100: bytes. Each output element is one read of the index
// (shared by all columns of the group through L1/L2), one random read of the
// source and one coalesced write. The columns are read through an array of
// pointers passed by value in the kernel's parameters, so nothing is stacked
// or copied to the card first. One block row of the 2-D grid per column.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

#define MZ_TAKE_MAX_COLS 16

namespace {

constexpr int kThreads = 256;

struct Cols {
  const void* in[MZ_TAKE_MAX_COLS];
  void* out[MZ_TAKE_MAX_COLS];
};

template <typename T>
__global__ void take_kernel(Cols cols, const int64_t* __restrict__ idx, int64_t n, int64_t m) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  int64_t i = __ldg(idx + j);
  i = i < 0 ? 0 : (i >= n ? n - 1 : i);
  const T* src = (const T*)cols.in[blockIdx.y];
  T* dst = (T*)cols.out[blockIdx.y];
  dst[j] = __ldg(src + i);
}

}  // namespace

// ins[k], outs[k]: pointers, on CUDA device `device`, of k columns of
// elem_bytes each (1, 2, 4 or 8); ins have n elements, outs and idx (int64)
// have m. Requires n > 0, m > 0 and k > 0. One launch for each
// MZ_TAKE_MAX_COLS columns (the pointers travel in the kernel's parameters).
extern "C" int mz_multi_take(int device, void* const* ins, void* const* outs, int k,
                             int elem_bytes, const void* idx, int64_t n, int64_t m,
                             void* stream) {
  if (k <= 0) return (int)cudaErrorInvalidValue;
  mz::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t* ix = (const int64_t*)idx;
  for (int c0 = 0; c0 < k; c0 += MZ_TAKE_MAX_COLS) {
    const int kc = k - c0 < MZ_TAKE_MAX_COLS ? k - c0 : MZ_TAKE_MAX_COLS;
    Cols cols;
    for (int c = 0; c < kc; ++c) {
      cols.in[c] = ins[c0 + c];
      cols.out[c] = outs[c0 + c];
    }
    dim3 grid((unsigned)((m + kThreads - 1) / kThreads), (unsigned)kc);
    switch (elem_bytes) {
      case 1: take_kernel<uint8_t><<<grid, kThreads, 0, st>>>(cols, ix, n, m); break;
      case 2: take_kernel<uint16_t><<<grid, kThreads, 0, st>>>(cols, ix, n, m); break;
      case 4: take_kernel<uint32_t><<<grid, kThreads, 0, st>>>(cols, ix, n, m); break;
      case 8: take_kernel<uint64_t><<<grid, kThreads, 0, st>>>(cols, ix, n, m); break;
      default: return (int)cudaErrorInvalidValue;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
