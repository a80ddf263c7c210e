// K3: the whole LastVoting run for each scenario in one launch.
//
// Replaces round_tpu/ops/fused.py::_lv_kernel (reached through lv_loop,
// pl.pallas_call at fused.py:1135).  LastVoting (LastVoting.scala:80-212)
// runs 4-round phases with the coordinator coord = (r / 4) % n; with
// phase = r / 4, k = r % 4 and side_r = r < heal_round ? side : 0:
//
//   k = 0 collect  senders i with ((colmask[i] && side_r[i] == side_r[coord]
//                  && keep(coord * n + i)) || i == coord) && active[i] reach
//                  the coordinator; it acts if have > n/2 (or r == 0 and
//                  have > 0): vote := x of the highest ts, ties to the
//                  smallest sender id; commit := 1.
//   k = 1 propose  receiver j gets the coordinator's vote if ((colmask[coord]
//                  && side_r[j] == side_r[coord] && keep(j * n + coord)) ||
//                  j == coord) && active[coord] && commit[coord]: x := vote,
//                  ts := phase.
//   k = 2 ack      as collect, senders guarded by ts[i] == phase; the
//                  coordinator becomes ready if have > n/2.
//   k = 3 decide   as propose, guarded by ready[coord]: receivers decide the
//                  vote and exit; every active lane resets ready and commit.
//
// Only active (not done) lanes change; done lanes are frozen
// (fused.py:1075-1077).  The coordinator's scalars are read from the
// state before the round, as the TPU kernel's masked reductions (`sc_at`)
// read them; here they are plain shared-memory reads at `coord`.
//
// Bound on the card: each round touches one receiver row (collect, ack) or
// one sender column (propose, decide) of the link mask, so a round costs n
// hashes and the n x n mask never exists.  n hashes per round are few: at
// n = 1024 the ALU time of the hashes and the bytes of the O(S*n) inputs
// and outputs are of the same order, and the kernel's own cost is the
// per-round barriers.  Design (the simple version): one block per
// scenario; each thread owns lanes j, j + blockDim, ...; the nine state
// vectors stay in shared memory for the whole run and only the final state
// is written.  The collect round's "max ts, ties to the smallest id" is one
// block reduction of the packed key (ts + 2) << 32 | (n - 1 - i); it and
// `have` are the only reductions of a round.  A link's keep bit is hashed
// only where the rest of its mask term holds, and the round loop ends once
// every lane of the scenario is done.
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kOut = 9;
constexpr unsigned kFull = 0xffffffffu;

struct LvParams {
  const int* x0;
  const int* crashed;
  const int* side;
  const int* crash_round;
  const int* heal_round;
  const int* rotate_down;
  const int* p8;
  const int* salt0;
  const int* salt1;
  int* out[kOut];  // x, ts, ready, commit, vote, decided, decision, done, dround
  int n;
  int rounds;
};

// _lv_keep (fused.py:952): rt_link_keep at one link index; no hash reaches
// 256, so a blackout keeps nothing without hashing.
__device__ __forceinline__ bool lv_keep(uint32_t idx, uint32_t salt0,
                                        uint32_t salt1r, int p8) {
  if (p8 >= 256) return false;
  return rt_link_keep(idx, salt0, salt1r, p8);
}

__global__ void __launch_bounds__(kThreads) lv_loop_kernel(LvParams p) {
  extern __shared__ int smem[];
  const int n = p.n;
  int* x = smem;          // [n] estimate
  int* ts = x + n;        // [n] phase of adoption, -1 initially
  int* ready = ts + n;    // [n] coordinator: acks from a majority
  int* commit = ready + n;  // [n] coordinator: vote chosen
  int* vote = commit + n;   // [n] coordinator's proposal
  int* decided = vote + n;  // [n]
  int* dec = decided + n;   // [n] decision, -1 until decided
  int* dn = dec + n;        // [n] done (exited)
  int* drd = dn + n;        // [n] decided_round
  int* crs = drd + n;       // [n] crash set
  int* sd = crs + n;        // [n] partition side
  __shared__ int have_s;
  __shared__ unsigned long long best_s;

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = (size_t)s * n;
  for (int i = tid; i < n; i += kThreads) {
    x[i] = p.x0[base + i];
    ts[i] = -1;
    ready[i] = 0;
    commit[i] = 0;
    vote[i] = 0;
    decided[i] = 0;
    dec[i] = -1;
    dn[i] = 0;
    drd[i] = -1;
    crs[i] = p.crashed[base + i] != 0;
    sd[i] = p.side[base + i];
  }
  const int cr = p.crash_round[s];
  const int hr = p.heal_round[s];
  const int rot = p.rotate_down[s];
  const int p8 = p.p8[s];
  const uint32_t s0 = (uint32_t)p.salt0[s];
  const int s1 = p.salt1[s];
  const int period = rot > 1 ? rot : 1;
  const int half = n / 2;

  for (int r = 0; r < p.rounds; ++r) {
    if (tid == 0) {
      have_s = 0;
      best_s = 0;
    }
    __syncthreads();
    const int phase = r / 4;
    const int k = r % 4;
    const int coord = phase % n;
    const int victim = (r / period) % n;
    const bool sided = r < hr;
    const uint32_t s1r = rt_salt1r(r, s1);
    // the coordinator's scalars, from the state before this round
    const int side_c = sided ? sd[coord] : 0;
    const bool cm_c =
        !(crs[coord] && r >= cr) && !(rot > 0 && coord == victim);
    const bool act_c = !dn[coord];
    const bool commit_c = commit[coord] != 0;
    const bool ready_c = ready[coord] != 0;
    const int vote_c = vote[coord];

    int any_active = 0;
    int my_have = 0;
    unsigned long long my_best = 0;
    for (int i = tid; i < n; i += kThreads) {
      const bool active = !dn[i];
      any_active |= active;
      if (!active || (k != 0 && k != 2)) continue;
      // collect / ack: sender i's message to the coordinator
      if (k == 2 && ts[i] != phase) continue;
      bool in = i == coord;
      if (!in) {
        const bool cm = !(crs[i] && r >= cr) && !(rot > 0 && i == victim);
        in = cm && (sided ? sd[i] : 0) == side_c &&
             lv_keep((uint32_t)coord * (uint32_t)n + (uint32_t)i, s0, s1r,
                     p8);
      }
      if (in) {
        ++my_have;
        const unsigned long long key =
            ((unsigned long long)(unsigned)(ts[i] + 2) << 32) |
            (unsigned)(n - 1 - i);
        if (key > my_best) my_best = key;
      }
    }
    if (k == 0 || k == 2) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        my_have += __shfl_xor_sync(kFull, my_have, off);
        const unsigned long long o = __shfl_xor_sync(kFull, my_best, off);
        if (o > my_best) my_best = o;
      }
      if ((tid & 31) == 0 && my_have > 0) {
        atomicAdd(&have_s, my_have);
        atomicMax(&best_s, my_best);
      }
    }
    // every lane done: the state is frozen for the remaining rounds
    if (!__syncthreads_or(any_active)) break;

    if (k == 0) {
      if (tid == 0 && act_c) {
        const int have = have_s;
        if (have > half || (r == 0 && have > 0)) {
          const int bi = n - 1 - (int)(best_s & 0xffffffffull);
          vote[coord] = x[bi];
          commit[coord] = 1;
        }
      }
    } else if (k == 2) {
      if (tid == 0 && act_c && have_s > half) ready[coord] = 1;
    } else {
      // propose / decide: the coordinator's broadcast to receiver j
      const bool guard = act_c && (k == 1 ? commit_c : ready_c);
      for (int j = tid; j < n; j += kThreads) {
        if (dn[j]) continue;
        bool got = false;
        if (guard) {
          got = j == coord ||
                (cm_c && (sided ? sd[j] : 0) == side_c &&
                 lv_keep((uint32_t)j * (uint32_t)n + (uint32_t)coord, s0,
                         s1r, p8));
        }
        if (k == 1) {
          if (got) {
            x[j] = vote_c;
            ts[j] = phase;
          }
        } else {
          if (got) {
            if (!decided[j]) dec[j] = vote_c;
            decided[j] = 1;
            dn[j] = 1;
            if (drd[j] < 0) drd[j] = r;
          }
          ready[j] = 0;
          commit[j] = 0;
        }
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < n; i += kThreads) {
    p.out[0][base + i] = x[i];
    p.out[1][base + i] = ts[i];
    p.out[2][base + i] = ready[i];
    p.out[3][base + i] = commit[i];
    p.out[4][base + i] = vote[i];
    p.out[5][base + i] = decided[i];
    p.out[6][base + i] = dec[i];
    p.out[7][base + i] = dn[i];
    p.out[8][base + i] = drd[i];
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
size_t lv_loop_smem_bytes(int n) { return sizeof(int) * (size_t)11 * n; }

// Inputs in lv_loop's order: x0, crashed, side ([S, n] int32),
// crash_round, heal_round, rotate_down, p8, salt0, salt1 ([S] int32);
// `outs` holds the nine [S, n] int32 outputs.  Launches on `stream` and
// returns cudaGetLastError().
int lv_loop_launch(const int* x0, const int* crashed, const int* side,
                   const int* crash_round, const int* heal_round,
                   const int* rotate_down, const int* p8, const int* salt0,
                   const int* salt1, int* const* outs, int S, int n,
                   int rounds, void* stream) {
  if (S <= 0 || n <= 0) return (int)cudaSuccess;
  LvParams p;
  p.x0 = x0;
  p.crashed = crashed;
  p.side = side;
  p.crash_round = crash_round;
  p.heal_round = heal_round;
  p.rotate_down = rotate_down;
  p.p8 = p8;
  p.salt0 = salt0;
  p.salt1 = salt1;
  for (int q = 0; q < kOut; ++q) p.out[q] = outs[q];
  p.n = n;
  p.rounds = rounds;
  const size_t smem = lv_loop_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      lv_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  lv_loop_kernel<<<S, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
