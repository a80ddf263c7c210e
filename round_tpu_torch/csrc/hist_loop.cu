// K1: the whole run of a histogram-round algorithm for each scenario in one
// launch, with three instances: OTR, FloodMin and Ben-Or.
//
// Replaces round_tpu/ops/fused.py::_loop_kernel (reached through hist_loop,
// pl.pallas_call at fused.py:841) for its OtrLoop (fused.py:394),
// FloodMinLoop (:440) and BenOrLoop (:481) instances.  One round skeleton,
// templated on an algorithm policy, does what the TPU template does; per
// scenario and round r, with the lane state kept on chip for all rounds:
//
//   colmask[i] = !(crashed[i] && r >= crash_round) && !(rotate_down > 0 &&
//                i == (r / max(rotate_down, 1)) % n)
//   sender[i]  = colmask[i] && !done[i] && p8 < 256
//   delivered  = sender[i] && i != j && keep(j * n + i) &&
//                (r >= heal_round || side[i] == side[j])
//   the policy accumulates the delivered payloads of subround r % phase;
//   an active lane hears itself (self-delivery depends on `active` alone,
//   not on colmask or p8); then the policy's update, the freeze of done
//   lanes, exit and decided_round (fused.py:670-675).
//
// The policies differ only in what a receiver keeps of its mailbox:
//   OtrPolicy      a [V] count column per thread in shared memory (the
//                  smallest most-often-received value needs the histogram);
//   FloodMinPolicy one running minimum in a register: FloodMin reads only
//                  min{v : counts[v] > 0} and not the size, so V=1000 (a
//                  2 MB histogram per block) costs nothing;
//   BenOrPolicy    four counters in registers (payload x + 2*can in
//                  subround 0, vote + 1 in subround 1).
// Payloads outside [0, V) are counted in the size and otherwise ignored, as
// the TPU one-hot ignores them (fused.py:467).
//
// Each instance comes in two link streams, a kernel template switch:
// hash mode (keep(idx) = fmix32 draw >= p8, bit-exact with round_tpu) and
// hw mode (round_tpu's hardware PRNG draw, fused.py:333-346, as the
// Philox4x32-10 stream of hash.cuh: keep(idx) = byte idx & 3 of element
// idx >> 2 >= min(p8, 255)).  Senders are compacted in atomicAdd order, so
// a receiver's links need not come in ascending order; RtHwStream calls
// Philox again whenever the counter idx >> 4 changes and reuses its four
// words otherwise (within a warp the compaction keeps lane order, so most
// runs of 16 links share one call).
//
// Bound on the card: the per-link hash where p8 > 0.  Every link of every
// round of every 0 < p8 < 256 scenario needs one murmur3 finalizer and the
// threshold compare: 8 operations on the ALU pipe and 3 multiplies on the
// FMA pipe, which runs alongside it, so the ALU pipe sets the floor.  In
// hw mode a link needs its byte's shift, mask and compare (3 ALU-pipe
// operations) and 1/16 of a Philox call (19 LOP3 on the ALU pipe, 20
// multiplies on the FMA pipe), about 4.2 ALU-pipe operations: half the
// hash mode's floor, though the hw loop, with its per-link counter test
// and word select, ran 44% slower than the hash loop at the flagship shape
// on an H100.  A p8 == 0 run draws nothing and reads O(S*n) inputs and
// writes O(S*n) outputs: it is bound by bytes.  Design (the simple version): one block
// per scenario; each thread owns receivers j, j + blockDim, ...; the state
// vectors live in shared memory for the whole run and only the final state
// is written out.  Each round the block compacts this round's senders
// (index and payload) into a shared list, then every thread walks that
// list for each of its receivers that is still active, hashing each link
// in registers.  Done lanes are frozen, so they are not counted for, and
// the round loop ends once every lane of the scenario is done.  The mask
// never exists in memory.  Tensor cores, TMA and persistence are left for
// later work.
#include <cuda_runtime.h>

#include "hash.cuh"

// The block's dynamic shared memory.  The policy state and OTR's counters
// are reached through int offsets into it rather than through pointers kept
// in structs, so every access is plainly a shared-memory one.
extern __shared__ int smem[];

namespace {

constexpr int kThreads = 512;
// Blocks per SM the register budget must allow (at most 42 registers a
// thread): OTR's shared counters hold it to 3 blocks at n=1024, V=16, and
// without the bound the OTR instance took 60 registers, room for 2.
constexpr int kMinBlocks = 3;
constexpr int kMaxOut = 7;

struct LoopParams {
  const int* x0;
  const int* crashed;
  const int* side;
  const int* crash_round;
  const int* heal_round;
  const int* rotate_down;
  const int* p8;
  const int* salt0;
  const int* salt1;
  int* out[kMaxOut];  // the policy's state slots, then done, decided_round
  int n;
  int V;
  int rounds;
  int param;  // OTR: after_decision; FloodMin: f; Ben-Or: unused
};

// What a round's update may read besides the state.
struct RoundInfo {
  int r;
  int k;  // subround r % phase_len
  int n;
  int V;
  int param;
  uint32_t salt0;
  uint32_t salt1;  // unmixed (the coin premixes it with r)
  int tid;
  int cnt;  // offset of the [V][kThreads] counters (OtrPolicy only)
  __device__ int& count(int v) const {
    return smem[cnt + v * kThreads + tid];
  }
};

// K state vectors of n ints each, slot q at smem[off + q * n].
template <int K>
struct State {
  int off;
  int n;
  __device__ int& operator()(int q, int i) const {
    return smem[off + q * n + i];
  }
};

// -- OTR (round_tpu/ops/fused.py:417-436): x, decided, decision, after ----
struct OtrPolicy {
  static constexpr int kState = 4;
  static constexpr int kDecided = 1;
  static constexpr int kPhase = 1;
  static constexpr bool kSharedCounts = true;
  struct Acc {};

  __device__ static void init(const State<kState>& st, int i, int x0,
                              int param) {
    st(0, i) = x0;
    st(1, i) = 0;
    st(2, i) = -1;
    st(3, i) = param;
  }
  __device__ static int payload(const State<kState>& st, int i, int) {
    return st(0, i);
  }
  __device__ static void reset(Acc&, const RoundInfo& ri) {
    for (int v = 0; v < ri.V; ++v) ri.count(v) = 0;
  }
  __device__ static void add(Acc&, const RoundInfo& ri, int c) {
    if ((unsigned)c < (unsigned)ri.V) ri.count(c) += 1;
  }
  __device__ static bool update(const State<kState>& st, int j, const Acc&,
                                const RoundInfo& ri, int size) {
    // smallest value among the most-often-received (strict > keeps the
    // first maximum while v ascends)
    int bestc = -1, bestv = ri.V;
    for (int v = 0; v < ri.V; ++v) {
      const int c = ri.count(v);
      if (c > bestc) {
        bestc = c;
        bestv = v;
      }
    }
    const int thr = (2 * ri.n) / 3;
    const bool quorum = size > thr;
    const bool superq = quorum && bestc > thr;
    const bool d = st(1, j) != 0;
    const bool d2 = d || superq;
    const int a2 = d2 ? st(3, j) - 1 : st(3, j);
    if (superq && !d) st(2, j) = bestv;
    st(1, j) = d2;
    st(3, j) = a2;
    if (quorum) st(0, j) = bestv;
    return d2 && a2 <= 0;
  }
};

// -- FloodMin (round_tpu/ops/fused.py:463-477): x, decided, decision ------
struct FloodMinPolicy {
  static constexpr int kState = 3;
  static constexpr int kDecided = 1;
  static constexpr int kPhase = 1;
  static constexpr bool kSharedCounts = false;
  struct Acc {
    int m;  // min{v in [0, V) delivered}, V when none
  };

  __device__ static void init(const State<kState>& st, int i, int x0, int) {
    st(0, i) = x0;
    st(1, i) = 0;
    st(2, i) = -1;
  }
  __device__ static int payload(const State<kState>& st, int i, int) {
    return st(0, i);
  }
  __device__ static void reset(Acc& a, const RoundInfo& ri) { a.m = ri.V; }
  __device__ static void add(Acc& a, const RoundInfo& ri, int c) {
    if ((unsigned)c < (unsigned)ri.V && c < a.m) a.m = c;
  }
  __device__ static bool update(const State<kState>& st, int j,
                                const Acc& a,
                                const RoundInfo& ri, int) {
    const int x = st(0, j);
    const int x2 = a.m < x ? a.m : x;
    const bool deciding = ri.r > ri.param;  // r > f, every lane alike
    if (deciding && !st(1, j)) st(2, j) = x2;
    st(1, j) = st(1, j) || deciding;
    st(0, j) = x2;
    return deciding;
  }
};

// -- Ben-Or (round_tpu/ops/fused.py:512-554): x, can, vote, decided,
//    decision; two subrounds per phase over one 4-value histogram ---------
struct BenOrPolicy {
  static constexpr int kState = 5;
  static constexpr int kDecided = 3;
  static constexpr int kPhase = 2;
  static constexpr bool kSharedCounts = false;
  struct Acc {
    int c0, c1, c2, c3;
  };

  __device__ static void init(const State<kState>& st, int i, int x0, int) {
    st(0, i) = x0;
    st(1, i) = 0;
    st(2, i) = -1;
    st(3, i) = 0;
    st(4, i) = 0;
  }
  __device__ static int payload(const State<kState>& st, int i, int k) {
    return k == 0 ? st(0, i) + 2 * st(1, i) : st(2, i) + 1;
  }
  __device__ static void reset(Acc& a, const RoundInfo&) {
    a.c0 = a.c1 = a.c2 = a.c3 = 0;
  }
  __device__ static void add(Acc& a, const RoundInfo&, int c) {
    a.c0 += c == 0;
    a.c1 += c == 1;
    a.c2 += c == 2;
    a.c3 += c == 3;
  }
  __device__ static bool update(const State<kState>& st, int j,
                                const Acc& a,
                                const RoundInfo& ri, int) {
    const int half = ri.n / 2;
    const int x = st(0, j);
    const int can = st(1, j);
    const bool decided = st(3, j) != 0;
    if (ri.k == 0) {
      const int t_cnt = a.c1 + a.c3;
      const int f_cnt = a.c0 + a.c2;
      const int vote_new = (t_cnt > half || a.c3 > 0)   ? 1
                           : (f_cnt > half || a.c2 > 0) ? 0
                                                        : -1;
      const bool deciding = can != 0;
      if (deciding && !decided) st(4, j) = x;
      st(3, j) = decided || deciding;
      if (!deciding) {
        st(2, j) = vote_new;
        st(1, j) = (a.c2 + a.c3) > 0;
      }
      return deciding;
    }
    const int t = a.c2;
    const int f = a.c1;
    if (!decided) {
      const bool coin = rt_hash_coin(ri.salt0, ri.salt1, (uint32_t)ri.r,
                                     (uint32_t)j);
      st(0, j) = t > half ? 1 : f > half ? 0 : t > 1 ? 1 : f > 1 ? 0 : coin;
      st(1, j) = t > half || f > half || can != 0;
    }
    return false;
  }
};

// Receiver j's mailbox of one round: walk the compacted senders, keep the
// links that survive, accumulate their payloads.  Returns the mailbox size
// without the self-delivery.  The partition test, the draw and its stream
// (kHw) are template switches, so each loop carries only the tests it
// needs.  As
// one loop the compiler kept both tests, and the round salt's multiply, in
// every link's path, and the OTR instance ran 35% slower than the
// single-purpose kernel it replaced (54.5 ms against 40.3 at the flagship
// shape on an H100); split, it runs faster than that kernel.
template <class A, bool kSided, bool kHashed, bool kHw>
__device__ __forceinline__ int mailbox(typename A::Acc& acc,
                                       const RoundInfo& ri, const int* cid,
                                       const int* cpay, const int* sd, int ns,
                                       int j, uint32_t s1r, int p8) {
  const uint32_t row = (uint32_t)j * (uint32_t)ri.n;
  const int sj = sd[j];
  RtHwStream hw(ri.salt0, s1r);
  const uint32_t thr = kHw ? rt_hw_threshold(p8) : (uint32_t)p8;
  int size = 0;
  for (int c = 0; c < ns; ++c) {
    const int i = cid[c];
    if (i == j) continue;
    if (kSided && sd[i] != sj) continue;
    if (kHashed) {
      const uint32_t idx = row + (uint32_t)i;
      if ((kHw ? hw.draw(idx) : rt_link_draw(idx, ri.salt0, s1r)) < thr)
        continue;
    }
    ++size;
    A::add(acc, ri, cpay[c]);
  }
  return size;
}

template <class A, bool kHw>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    hist_loop_kernel(LoopParams p) {
  constexpr int K = A::kState;
  const int n = p.n;
  int* cid = smem;      // [n] this round's senders (any order)
  int* cpay = cid + n;  // [n] their payloads (state before the update)
  int* sd = cpay + n;   // [n] partition side
  int* crs = sd + n;    // [n] crash set
  const State<K> st{4 * n, n};  // K x [n] policy state
  int* dn = crs + n + K * n;    // [n] done (exited)
  int* drd = dn + n;            // [n] decided_round
  __shared__ int nsend;

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = (size_t)s * n;
  for (int i = tid; i < n; i += kThreads) {
    A::init(st, i, p.x0[base + i], p.param);
    crs[i] = p.crashed[base + i] != 0;
    sd[i] = p.side[base + i];
    dn[i] = 0;
    drd[i] = -1;
  }
  const int cr = p.crash_round[s];
  const int hr = p.heal_round[s];
  const int rot = p.rotate_down[s];
  const int p8 = p.p8[s];
  RoundInfo ri;
  ri.n = n;
  ri.V = p.V;
  ri.param = p.param;
  ri.salt0 = (uint32_t)p.salt0[s];
  ri.salt1 = (uint32_t)p.salt1[s];
  ri.tid = tid;
  ri.cnt = (6 + K) * n;  // [V][kThreads], present when A::kSharedCounts
  const int period = rot > 1 ? rot : 1;
  const bool blackout = p8 >= 256;

  for (int r = 0; r < p.rounds; ++r) {
    if (tid == 0) nsend = 0;
    __syncthreads();
    const int k = r % A::kPhase;
    const int victim = (r / period) % n;
    const bool sided = r < hr;
    const uint32_t s1r = rt_salt1r(r, (int)ri.salt1);
    ri.r = r;
    ri.k = k;
    int any_active = 0;
    for (int i = tid; i < n; i += kThreads) {
      const bool active = !dn[i];
      any_active |= active;
      const bool alive = !(crs[i] && r >= cr);
      const bool rotated = rot > 0 && i == victim;
      if (active && alive && !rotated && !blackout) {
        const int c = atomicAdd(&nsend, 1);
        cid[c] = i;
        cpay[c] = A::payload(st, i, k);
      }
    }
    // every lane done: the state is frozen for the remaining rounds
    if (!__syncthreads_or(any_active)) break;
    const int ns = nsend;

    for (int j = tid; j < n; j += kThreads) {
      if (dn[j]) continue;  // frozen: its mailbox would be discarded
      typename A::Acc acc;
      A::reset(acc, ri);
      int size;
      if (sided)
        size = p8 > 0 ? mailbox<A, true, true, kHw>(acc, ri, cid, cpay, sd,
                                                    ns, j, s1r, p8)
                      : mailbox<A, true, false, kHw>(acc, ri, cid, cpay, sd,
                                                     ns, j, s1r, p8);
      else
        size = p8 > 0 ? mailbox<A, false, true, kHw>(acc, ri, cid, cpay, sd,
                                                     ns, j, s1r, p8)
                      : mailbox<A, false, false, kHw>(acc, ri, cid, cpay, sd,
                                                      ns, j, s1r, p8);
      // self-delivery: an active lane hears its own payload (the state
      // before the update, which only this thread writes)
      ++size;
      A::add(acc, ri, A::payload(st, j, k));
      if (A::update(st, j, acc, ri, size)) dn[j] = 1;
      if (st(A::kDecided, j) && drd[j] < 0) drd[j] = r;
    }
    __syncthreads();
  }

  for (int i = tid; i < n; i += kThreads) {
#pragma unroll
    for (int q = 0; q < K; ++q) p.out[q][base + i] = st(q, i);
    p.out[K][base + i] = dn[i];
    p.out[K + 1][base + i] = drd[i];
  }
}

template <class A>
size_t smem_bytes(int n, int V) {
  return sizeof(int) * ((size_t)(6 + A::kState) * n +
                        (A::kSharedCounts ? (size_t)V * kThreads : 0));
}

template <class A, bool kHw>
int launch_stream(const LoopParams& p, int S, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      hist_loop_kernel<A, kHw>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  hist_loop_kernel<A, kHw><<<S, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <class A>
int launch(const int* const* ins, int* const* outs, int S, int n, int V,
           int rounds, int param, int hw, void* stream) {
  if (S <= 0 || n <= 0) return (int)cudaSuccess;
  LoopParams p;
  p.x0 = ins[0];
  p.crashed = ins[1];
  p.side = ins[2];
  p.crash_round = ins[3];
  p.heal_round = ins[4];
  p.rotate_down = ins[5];
  p.p8 = ins[6];
  p.salt0 = ins[7];
  p.salt1 = ins[8];
  for (int q = 0; q < kMaxOut; ++q)
    p.out[q] = q < A::kState + 2 ? outs[q] : nullptr;
  p.n = n;
  p.V = V;
  p.rounds = rounds;
  p.param = param;
  const size_t smem = smem_bytes<A>(n, V);
  return hw ? launch_stream<A, true>(p, S, smem, stream)
            : launch_stream<A, false>(p, S, smem, stream);
}

}  // namespace

// C entry points, one pair per instance.  Inputs in hist_loop's order:
// x0, crashed, side ([S, n] int32), crash_round, heal_round, rotate_down,
// p8, salt0, salt1 ([S] int32).  Outputs: the policy's state slots, done,
// decided_round ([S, n] int32).  hw != 0 draws the links from the hw-mode
// Philox stream, else from the hash.  Each launch runs on `stream` and
// returns cudaGetLastError().
extern "C" {

#define RT_LOOP_ENTRY(NAME, POLICY)                                          \
  size_t NAME##_smem_bytes(int n, int V) { return smem_bytes<POLICY>(n, V); } \
  int NAME##_launch(const int* x0, const int* crashed, const int* side,     \
                    const int* crash_round, const int* heal_round,          \
                    const int* rotate_down, const int* p8, const int* salt0, \
                    const int* salt1, int* const* outs, int S, int n, int V, \
                    int rounds, int param, int hw, void* stream) {          \
    const int* ins[9] = {x0,         crashed,     side, crash_round, \
                         heal_round, rotate_down, p8,   salt0,       \
                         salt1};                                             \
    return launch<POLICY>(ins, outs, S, n, V, rounds, param, hw, stream);   \
  }

RT_LOOP_ENTRY(otr_loop, OtrPolicy)
RT_LOOP_ENTRY(floodmin_loop, FloodMinPolicy)
RT_LOOP_ENTRY(benor_loop, BenOrPolicy)

#undef RT_LOOP_ENTRY

}  // extern "C"
