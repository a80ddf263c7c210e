// P1 and P2: the two device probes of the bisect tool.
//
// probe_double replaces tools/tpu_bisect.py::stage_pallas_min (pl.pallas_call
// at tpu_bisect.py:40): o = 2 * x over a float32 array.  It reads 4 bytes and
// writes 4 bytes per element, so it is bound by bytes; one thread per
// element, consecutive threads on consecutive addresses.
//
// philox_bits replaces tools/tpu_bisect.py::stage_pallas_prng (pl.pallas_call
// at tpu_bisect.py:57), which seeds the TPU's hardware PRNG with two words
// and draws a [128, 128] block of bits.  Here the generator is the hw-mode
// stream of hash.cuh: element e is word e & 3 of Philox4x32-10(counter
// (c0 + (e >> 2), c1, c2, c3), key (key[0], key[1])), as int32.  One thread
// per counter writes its four words; a nonzero counter base (c0..c3) lets
// the known-answer vectors of Random123 run through the same kernel.  At the
// bisect shape it writes 64 KB from 4,096 Philox calls, so bytes bound it.
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void probe_double_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, long long m) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < m) out[i] = x[i] * 2.0f;
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

}  // namespace

extern "C" {

// out[i] = 2 * x[i] for i < m, on `stream`.  Returns cudaGetLastError().
int probe_double_launch(const float* x, float* out, long long m,
                        void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  const long long blocks = (m + kThreads - 1) / kThreads;
  probe_double_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(x, out, m);
  return (int)cudaGetLastError();
}

// m words of the Philox stream keyed key[0], key[1] (a device array of two
// int32) from counter (c0, c1, c2, c3) on, on `stream`.  Returns
// cudaGetLastError().
int philox_bits_launch(const int* key, int* out, long long m, unsigned c0,
                       unsigned c1, unsigned c2, unsigned c3, void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  const long long calls = (m + 3) / 4;
  const long long blocks = (calls + kThreads - 1) / kThreads;
  philox_bits_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      key, out, m, make_uint4(c0, c1, c2, c3));
  return (int)cudaGetLastError();
}

}  // extern "C"
