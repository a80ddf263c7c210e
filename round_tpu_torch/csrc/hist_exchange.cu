// K2: the fused masked exchange + per-value histogram of one round.
//
// Replaces round_tpu/ops/fused.py::_kernel (reached through hist_exchange,
// pl.pallas_call at fused.py:293).  For every scenario s, value v and
// receiver j:
//
//   counts[s, v, j] = rowmask[j] * #{ i != j : senders[i] && vals[i] == v
//                                      && side[i] == side[j]
//                                      && keep(j * n + i) }
//
// with keep the link draw of hash.cuh: the hash-mode fmix32 draw, or with
// hw != 0 the hw-mode Philox4x32-10 stream (round_tpu's hardware-PRNG
// branch of _keep_mask, fused.py:333-346).  Each thread walks its
// receiver's links in ascending sender order, so RtHwStream makes one
// Philox call per 16 links and keeps its four words in registers.  The
// wrapper
// (round_tpu_torch/ops/fused.py::hist_exchange) silences senders of p8 >= 256
// scenarios and adds the self-delivery diagonal, as the TPU wrapper does.
//
// Bound on the card: the per-link hash.  Every link of every p8 > 0 scenario
// needs its own murmur3 finalizer and the threshold compare: 8 operations on
// the ALU pipe and 3 multiplies on the FMA pipe, which runs alongside it, so
// the ALU pipe sets the floor.  It reads O(S*n) inputs and writes O(S*V*n)
// counts; at the main-path shape the ALU time is about 15x the byte time.
// In hw mode a link needs 3 ALU-pipe operations (its byte's shift, mask
// and compare) and 1/16 of a Philox call (19 LOP3, and 20 multiplies on
// the FMA pipe): about 4.2 ALU-pipe operations.  Design (the simple first
// version): grid (S, ceil(n/256)), one thread per receiver j; the
// block stages the scenario's sender codes and sides in shared memory and
// each thread walks all senders, hashing each link in registers and
// counting into its own column of a shared [V][256] int32 array (no
// atomics).  The mask never exists in memory.  A p8 == 0 scenario skips the
// hash.  Tensor cores, TMA and persistence are left for later work.
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kHw>
__global__ void hist_exchange_kernel(const int* __restrict__ vals,
                                     const int* __restrict__ senders,
                                     const int* __restrict__ rowmask,
                                     const int* __restrict__ side,
                                     const int* __restrict__ salt0,
                                     const int* __restrict__ salt1r,
                                     const int* __restrict__ p8s,
                                     float* __restrict__ out, int n, int V) {
  extern __shared__ int smem[];
  int* code = smem;         // [n]  vals[i] if senders[i] else -1
  int* sd = code + n;       // [n]  side (only when side != nullptr)
  int* cnt = sd + n;        // [V][kThreads] per-receiver counters

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = (size_t)s * n;
  for (int i = tid; i < n; i += kThreads) {
    int v = vals[base + i];
    code[i] = (senders[base + i] != 0 && v >= 0 && v < V) ? v : -1;
    sd[i] = side ? side[base + i] : 0;
  }
  __syncthreads();

  const int j = blockIdx.y * kThreads + tid;
  if (j >= n) return;
  for (int v = 0; v < V; ++v) cnt[v * kThreads + tid] = 0;

  const int p8 = p8s[s];
  const uint32_t s0 = (uint32_t)salt0[s];
  const uint32_t s1r = (uint32_t)salt1r[s];
  const uint32_t row = (uint32_t)j * (uint32_t)n;
  const int sj = sd[j];
  RtHwStream hw(s0, s1r);
  const uint32_t thr = rt_hw_threshold(p8);
  for (int i = 0; i < n; ++i) {
    const int c = code[i];
    if (c < 0 || i == j || sd[i] != sj) continue;
    if (kHw) {
      if (p8 > 0 && hw.draw(row + (uint32_t)i) < thr) continue;
    } else if (!rt_link_keep(row + (uint32_t)i, s0, s1r, p8)) {
      continue;
    }
    cnt[c * kThreads + tid] += 1;
  }

  const float rm = (rowmask == nullptr || rowmask[base + j] != 0) ? 1.f : 0.f;
  float* o = out + (size_t)s * V * n + j;
  for (int v = 0; v < V; ++v) o[(size_t)v * n] = rm * (float)cnt[v * kThreads + tid];
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
size_t hist_exchange_smem_bytes(int n, int V) {
  return sizeof(int) * ((size_t)2 * n + (size_t)V * kThreads);
}

// Launch on `stream`; rowmask and side may be null; hw != 0 draws the
// links from the hw-mode Philox stream.  Returns cudaGetLastError().
int hist_exchange_launch(const int* vals, const int* senders,
                         const int* rowmask, const int* side,
                         const int* salt0, const int* salt1r, const int* p8,
                         float* out, int S, int n, int V, int hw,
                         void* stream) {
  if (S <= 0 || n <= 0) return (int)cudaSuccess;
  const size_t smem = hist_exchange_smem_bytes(n, V);
  auto kernel = hw ? hist_exchange_kernel<true> : hist_exchange_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S, (n + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      vals, senders, rowmask, side, salt0, salt1r, p8, out, n, V);
  return (int)cudaGetLastError();
}

}  // extern "C"
