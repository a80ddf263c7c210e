// K1: the whole OTR run for each scenario in one launch.
//
// Replaces round_tpu/ops/fused.py::_loop_kernel (reached through hist_loop
// and otr_loop, pl.pallas_call at fused.py:841) for its OtrLoop instance.
// Per scenario and round r, with the lane state kept on chip for all rounds:
//
//   colmask[i] = !(crashed[i] && r >= crash_round) && !(rotate_down > 0 &&
//                i == (r / max(rotate_down, 1)) % n)
//   sender[i]  = colmask[i] && !done[i] && p8 < 256
//   delivered  = sender[i] && i != j && keep(j * n + i) &&
//                (r >= heal_round || side[i] == side[j])
//   cnt[v], size over the delivered senders; an active lane hears itself
//   (self-delivery depends on `active` alone, not on colmask or p8)
//   then OtrLoop.update (round_tpu/ops/fused.py:417-436) in integers, the
//   freeze of done lanes, exit and decided_round (fused.py:670-675).
//
// Bound on the card: the per-link hash.  Every link of every round of every
// p8 > 0 scenario needs one murmur3 finalizer and the threshold compare: 8
// operations on the ALU pipe and 3 multiplies on the FMA pipe, which runs
// alongside it, so the ALU pipe sets the floor.  The kernel reads O(S*n)
// inputs and writes O(S*n) outputs; at the flagship shape the ALU time is
// about 100x the byte time.  Design
// (the simple version): one block per scenario; each thread owns receivers
// j, j + blockDim, ...; the six state vectors live in shared memory for the
// whole run and only the final state is written out.  Each round the block
// compacts this round's senders (index and payload) into a shared list,
// then every thread walks that list for each of its receivers that is
// still active, hashing each link in registers and counting into its own
// column of a shared [V][blockDim] array (no atomics on the counts).
// Done lanes are frozen, so they are not counted for, and the round loop
// ends once every lane of the scenario is done.  A p8 == 0 scenario skips
// the hash.  The mask never exists in memory.  Tensor cores (an int8
// one-hot x keep tile), TMA and persistence are left for later work.
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
otr_loop_kernel(const int* __restrict__ x0, const int* __restrict__ crashed,
                const int* __restrict__ side,
                const int* __restrict__ crash_round,
                const int* __restrict__ heal_round,
                const int* __restrict__ rotate_down,
                const int* __restrict__ p8s, const int* __restrict__ salt0,
                const int* __restrict__ salt1, int* __restrict__ out_x,
                int* __restrict__ out_decided, int* __restrict__ out_decision,
                int* __restrict__ out_after, int* __restrict__ out_done,
                int* __restrict__ out_dround, int n, int V, int rounds,
                int after_decision) {
  extern __shared__ int smem[];
  int* cid = smem;      // [n] this round's senders (any order)
  int* cpay = cid + n;  // [n] their payloads (x before the update)
  int* sd = cpay + n;   // [n] partition side
  int* crs = sd + n;    // [n] crash set
  int* x = crs + n;     // [n] state: estimate
  int* dec = x + n;     // [n] state: decided
  int* dcs = dec + n;   // [n] state: decision
  int* aft = dcs + n;   // [n] state: rounds left after deciding
  int* dn = aft + n;    // [n] done (exited)
  int* drd = dn + n;    // [n] decided_round
  int* cnt = drd + n;   // [V][kThreads] per-receiver counters
  __shared__ int nsend;

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = (size_t)s * n;
  for (int i = tid; i < n; i += kThreads) {
    x[i] = x0[base + i];
    crs[i] = crashed[base + i] != 0;
    sd[i] = side[base + i];
    dec[i] = 0;
    dcs[i] = -1;
    aft[i] = after_decision;
    dn[i] = 0;
    drd[i] = -1;
  }
  const int cr = crash_round[s];
  const int hr = heal_round[s];
  const int rot = rotate_down[s];
  const int p8 = p8s[s];
  const uint32_t s0 = (uint32_t)salt0[s];
  const int s1 = salt1[s];
  const int period = rot > 1 ? rot : 1;
  const int thr = (2 * n) / 3;
  const bool blackout = p8 >= 256;

  for (int r = 0; r < rounds; ++r) {
    if (tid == 0) nsend = 0;
    __syncthreads();
    const int victim = (r / period) % n;
    const bool sided = r < hr;
    const uint32_t s1r = rt_salt1r(r, s1);
    int any_active = 0;
    for (int i = tid; i < n; i += kThreads) {
      const bool active = !dn[i];
      any_active |= active;
      const bool alive = !(crs[i] && r >= cr);
      const bool rotated = rot > 0 && i == victim;
      if (active && alive && !rotated && !blackout) {
        const int k = atomicAdd(&nsend, 1);
        cid[k] = i;
        cpay[k] = x[i];
      }
    }
    // every lane done: the state is frozen for the remaining rounds
    if (!__syncthreads_or(any_active)) break;
    const int ns = nsend;

    for (int j = tid; j < n; j += kThreads) {
      if (dn[j]) continue;  // frozen: its counts would be discarded
      for (int v = 0; v < V; ++v) cnt[v * kThreads + tid] = 0;
      int size = 0;
      const uint32_t row = (uint32_t)j * (uint32_t)n;
      const int sj = sd[j];
      for (int k = 0; k < ns; ++k) {
        const int i = cid[k];
        if (i == j) continue;
        if (sided && sd[i] != sj) continue;
        if (!rt_link_keep(row + (uint32_t)i, s0, s1r, p8)) continue;
        ++size;
        const unsigned c = (unsigned)cpay[k];
        if (c < (unsigned)V) cnt[c * kThreads + tid] += 1;
      }
      // self-delivery: an active lane hears its own payload (x before the
      // update, which only this thread writes)
      const int xj = x[j];
      ++size;
      if ((unsigned)xj < (unsigned)V) cnt[xj * kThreads + tid] += 1;
      // smallest value among the most-often-received (strict > keeps the
      // first maximum while v ascends)
      int bestc = -1, bestv = V;
      for (int v = 0; v < V; ++v) {
        const int c = cnt[v * kThreads + tid];
        if (c > bestc) {
          bestc = c;
          bestv = v;
        }
      }
      const bool quorum = size > thr;
      const bool superq = quorum && bestc > thr;
      const bool d = dec[j] != 0;
      const bool d2 = d || superq;
      const int a2 = d2 ? aft[j] - 1 : aft[j];
      if (superq && !d) dcs[j] = bestv;
      dec[j] = d2;
      aft[j] = a2;
      x[j] = quorum ? bestv : xj;
      if (d2 && a2 <= 0) dn[j] = 1;
      if (d2 && drd[j] < 0) drd[j] = r;
    }
    __syncthreads();
  }

  for (int i = tid; i < n; i += kThreads) {
    out_x[base + i] = x[i];
    out_decided[base + i] = dec[i];
    out_decision[base + i] = dcs[i];
    out_after[base + i] = aft[i];
    out_done[base + i] = dn[i];
    out_dround[base + i] = drd[i];
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
size_t otr_loop_smem_bytes(int n, int V) {
  return sizeof(int) * ((size_t)10 * n + (size_t)V * kThreads);
}

// Launch on `stream`.  Returns cudaGetLastError().
int otr_loop_launch(const int* x0, const int* crashed, const int* side,
                    const int* crash_round, const int* heal_round,
                    const int* rotate_down, const int* p8, const int* salt0,
                    const int* salt1, int* out_x, int* out_decided,
                    int* out_decision, int* out_after, int* out_done,
                    int* out_dround, int S, int n, int V, int rounds,
                    int after_decision, void* stream) {
  if (S <= 0 || n <= 0) return (int)cudaSuccess;
  const size_t smem = otr_loop_smem_bytes(n, V);
  cudaError_t err = cudaFuncSetAttribute(
      otr_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  otr_loop_kernel<<<S, kThreads, smem, (cudaStream_t)stream>>>(
      x0, crashed, side, crash_round, heal_round, rotate_down, p8, salt0,
      salt1, out_x, out_decided, out_decision, out_after, out_done,
      out_dround, n, V, rounds, after_decision);
  return (int)cudaGetLastError();
}

}  // extern "C"
