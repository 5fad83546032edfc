// The launch side that every kernel library of the port shares.
//
// Each C entry point takes the index of the CUDA device its tensors lie on
// and makes that device current for the launch (DeviceGuard), then restores
// the thread's device: a mesh worker's thread may launch on another card
// than its current one, and a stream can take launches only from its own
// device. The wrappers (ops/kernels/*.py) pass the index and the device's
// current stream, and raise on the error code the entry point returns.

#pragma once

#include <cuda_runtime.h>

namespace mz {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      set_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (set_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool set_ = false;
  cudaError_t err_;
};

}  // namespace mz
