// P1 and P2: the two device probes of the bisect tool.
//
// probe_double replaces tools/tpu_bisect.py::stage_pallas_min (pl.pallas_call
// at tpu_bisect.py:40): o = 2 * x over a float32 array.  At the bisect
// shape, [128, 128], it moves 128 KB: on this card that is tens of
// nanoseconds of memory traffic against microseconds of launch and of the
// host's issue, so the call is bound by launch and host issue, not by bytes.
// The redesign is the host route (ops/fused.py::probe_double: the raw
// stream by device index, the entry point bound once, no device context);
// the kernel does its part with one thread per four floats, a 16-byte
// float4 load and store where both pointers are 16-byte aligned, scalar
// accesses where they are not and for the tail of m % 4 floats.
//
// philox_bits replaces tools/tpu_bisect.py::stage_pallas_prng (pl.pallas_call
// at tpu_bisect.py:57), which seeds the TPU's hardware PRNG with two words
// and draws a [128, 128] block of bits.  Here the generator is the hw-mode
// stream of hash.cuh: element e is word e & 3 of Philox4x32-10(counter
// (c0 + (e >> 2), c1, c2, c3), key (key[0], key[1])), as int32.  One thread
// per counter writes its four words; a nonzero counter base (c0..c3) lets
// the known-answer vectors of Random123 run through the same kernel.  At the
// bisect shape it writes 64 KB from 4,096 Philox calls; like P1, it is bound
// by launch and host issue, and takes the same host route.
//
// Each entry point takes the device index and makes that device current
// only when it is not, restoring the caller's afterwards.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void probe_double_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, long long m,
                                    int vec) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long e = 4 * t;
  if (e >= m) return;
  if (vec && e + 4 <= m) {
    float4 v = reinterpret_cast<const float4*>(x)[t];
    v.x *= 2.0f;
    v.y *= 2.0f;
    v.z *= 2.0f;
    v.w *= 2.0f;
    reinterpret_cast<float4*>(out)[t] = v;
    return;
  }
  for (long long i = e; i < e + 4 && i < m; ++i) out[i] = x[i] * 2.0f;
}

__global__ void philox_bits_kernel(const int* __restrict__ key,
                                   int* __restrict__ out, long long m,
                                   uint4 base) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long e = 4 * t;
  if (e >= m) return;
  const uint4 w = rt_philox4x32_10(
      make_uint4(base.x + (uint32_t)t, base.y, base.z, base.w),
      (uint32_t)key[0], (uint32_t)key[1]);
  out[e] = (int)w.x;
  if (e + 1 < m) out[e + 1] = (int)w.y;
  if (e + 2 < m) out[e + 2] = (int)w.z;
  if (e + 3 < m) out[e + 3] = (int)w.w;
}

// Blocks of kThreads threads for one thread per four of m elements.
unsigned blocks_for(long long m) {
  const long long threads = (m + 3) / 4;
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// out[i] = 2 * x[i] for i < m, on `stream` of `device`.  Returns
// cudaGetLastError().
int probe_double_launch(const float* x, float* out, long long m, int device,
                        void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int vec = (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
  probe_double_kernel<<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      x, out, m, vec);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

// m words of the Philox stream keyed key[0], key[1] (a device array of two
// int32) from counter (c0, c1, c2, c3) on, on `stream` of `device`.
// Returns cudaGetLastError().
int philox_bits_launch(const int* key, int* out, long long m, unsigned c0,
                       unsigned c1, unsigned c2, unsigned c3, int device,
                       void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  philox_bits_kernel<<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      key, out, m, make_uint4(c0, c1, c2, c3));
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // extern "C"
