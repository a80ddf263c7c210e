// Host helpers of the lean launch route, shared by the C entry points of
// K1 (hist_loop.cu), K2 (hist_exchange.cu) and K3 (lv_loop.cu).
//
// The Python wrappers (ops/fused.py) bind each entry point once, pass the
// device index and the raw stream of that device, and take no device
// context and no lock.  An entry point then makes the device current only
// when it is not (RtDevice), and raises a kernel's dynamic shared-memory
// limit only when a launch needs more than it was last raised to on that
// device (RtSmemLimit): once per (kernel, size), not on every launch.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <mutex>

// Makes `device` current for the entry point's scope, unless it already is.
class RtDevice {
 public:
  explicit RtDevice(int device) : device_(device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device_) err_ = cudaSetDevice(device_);
  }
  ~RtDevice() {
    if (err_ == cudaSuccess && prev_ != device_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int device_;
  int prev_ = 0;
  cudaError_t err_;
};

// The dynamic shared-memory limit of one kernel, per device.  The limit
// only grows: a lowered one could refuse another thread's launch of the
// same kernel.  Keep one per kernel as a function-local static (zeroed
// before first use).
struct RtSmemLimit {
  static constexpr int kDevices = 64;
  static constexpr size_t kDefault = 48 * 1024;  // no attribute needed
  std::atomic<int> bytes[kDevices];
  std::mutex mu;

  // Allow `need` bytes for `kernel` on the current device `device`.
  template <class K>
  cudaError_t raise(K* kernel, int device, size_t need) {
    if (need <= kDefault) return cudaSuccess;
    if (device < 0 || device >= kDevices)
      return cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)need);
    if ((size_t)bytes[device].load(std::memory_order_acquire) >= need)
      return cudaSuccess;
    std::lock_guard<std::mutex> lock(mu);
    if ((size_t)bytes[device].load(std::memory_order_relaxed) >= need)
      return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)need);
    if (err == cudaSuccess)
      bytes[device].store((int)need, std::memory_order_release);
    return err;
  }
};
