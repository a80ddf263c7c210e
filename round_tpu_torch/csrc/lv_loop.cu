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
// read them.
//
// Bound on the card: each round touches one receiver row (collect, ack) or
// one sender column (propose, decide) of the link mask, so a round costs n
// hashes and the n x n mask never exists.  At n = 1024 the hashes' ALU time
// and the bytes of the O(S*n) inputs and outputs are of the same order
// (2 ints and the crash byte read a lane, 9 ints written), so the kernel
// is bound by bytes wherever the run is short, and the work of a round is
// too small to pay for a block barrier.
//
// Design: a warp per scenario, several scenarios a block, and no block
// barrier anywhere (a warp whose scenario is past S returns at once).
//   - collect / ack: lane l takes the senders i = l (mod 32); `have` is the
//     popcount of the ballots of who got through, and the highest-ts,
//     smallest-id pick is one __reduce_max_sync of the 32-bit key
//     (ts + 2) * n + (n - 1 - i) (the wrapper refuses a run whose key could
//     reach 2^32, fused.py::lv_key_fits);
//   - propose / decide: lane l takes the receivers j = l (mod 32);
//   - state: done is a bitmask (a LastVoting lane decides exactly when it
//     exits, so decided is the same mask), and so is the crash set; ready
//     and commit are nonzero only at the current phase's coordinator (set
//     by it at k = 0 and 2 while it is active, cleared at k = 3 while it
//     still is), so each is one flag in a register; x, ts, vote, decision
//     and decided_round stay in shared memory with the partition sides, and
//     only the final state is written, coalesced;
//   - the loops carry no branch: the mask terms are bitwise, the hash is
//     switched per scenario (none where p8 <= 0 or p8 >= 256) and, where
//     the scenario draws, every lane hashes its link (a branch around the
//     hash of the links whose other terms fail put a reconvergence point
//     in every iteration and kept the unrolled iterations from
//     overlapping); the collect and ack loops carry no warp vote either
//     (each lane counts, one __reduce_add_sync ends it);
//   - the round loop ends once every lane is done, or at a phase's start
//     with at most n / 2 lanes left: from there no collect or ack reaches
//     a majority, so no flag is set and no lane changes again (exact: the
//     nine outputs are those of the full run).
// A scenario takes 6 * 4 * n + 8 * n / 32 bytes of shared memory (24.8 KB
// at n = 1024): blocks of 4 scenarios, two blocks an SM at n = 1024.
#include <cuda_runtime.h>

#include "hash.cuh"
#include "launch.cuh"

namespace {

constexpr int kMaxWarps = 4;  // scenarios a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // a block's shared memory on Hopper

struct LvParams {
  const int* x0;
  const uint8_t* crashed;  // [S, n] bool
  const int* side;
  const int* crash_round;
  const int* heal_round;
  const int* rotate_down;
  const int* p8;
  const int* salt0;
  const int* salt1;
  int* out;  // [9][S][n]: x, ts, ready, commit, vote, decided, decision,
             // done, decided_round
  int S;
  int n;
  int rounds;
};

// Lanes padded to whole words of 32.
__host__ __device__ __forceinline__ int lv_pad(int n) {
  return (n + 31) / 32 * 32;
}

// Ints of one scenario's shared memory: x, ts, vote, decision,
// decided_round and side (padded lanes each), then the done and crash
// words.
__host__ __device__ __forceinline__ size_t lv_ints(int n) {
  const int np = lv_pad(n);
  return 6 * (size_t)np + 2 * (size_t)(np / 32);
}

__device__ __forceinline__ bool bit(unsigned w, int b) {
  return (w >> b) & 1u;
}

// What a round's loops read besides the state: its scalars, the
// coordinator's, the stream's.
struct LvRound {
  int n, nw, lane, phase, coord, victim, rot, side_c, p8;
  bool sided, crashing;
  uint32_t s0, s1r;
};

// _lv_keep (fused.py:952) at link idx: kHash, where 0 < p8 < 256, draws it
// (rt_link_draw >= p8); else p8 <= 0 keeps every link and a blackout
// none, with no hash.  The switch is per scenario, so the loops below
// carry no branch on it.
template <bool kHash>
__device__ __forceinline__ bool lv_keep(const LvRound& q, uint32_t idx) {
  if (kHash) return rt_link_draw(idx, q.s0, q.s1r) >= (uint32_t)q.p8;
  return q.p8 <= 0;
}

// collect (kAck false) / ack (true): each lane counts the senders i = lane
// (mod 32) that reach the coordinator and keeps the largest key of them.
// Bitwise logic and no warp vote, so the unrolled iterations overlap.
template <bool kHash, bool kAck>
__device__ __forceinline__ void lv_collect(const LvRound& q, const int* ts,
                                           const int* sd,
                                           const unsigned* dnb,
                                           const unsigned* crb, int& cnt,
                                           unsigned& best) {
  const uint32_t row = (uint32_t)q.coord * (uint32_t)q.n;
#pragma unroll 8
  for (int c = 0; c < q.nw; ++c) {
    const int i = c * 32 + q.lane;
    const int tsi = ts[i];
    const bool cm = !(q.crashing & bit(crb[c], q.lane)) &
                    !((q.rot > 0) & (i == q.victim));
    const bool link = cm & (!q.sided | (sd[i] == q.side_c)) &
                      lv_keep<kHash>(q, row + (uint32_t)i);
    const bool in = (!bit(dnb[c], q.lane)) & (!kAck | (tsi == q.phase)) &
                    ((i == q.coord) | link);
    cnt += in;
    const unsigned key =
        (unsigned)(tsi + 2) * (unsigned)q.n + (unsigned)(q.n - 1 - i);
    best = in & (key > best) ? key : best;
  }
}

// propose (kDecide false) / decide (true): the coordinator's broadcast to
// the receivers j = lane (mod 32).  Returns the lanes that decided.
template <bool kHash, bool kDecide>
__device__ __forceinline__ int lv_broadcast(const LvRound& q, bool cm_c,
                                            int vote_c, int r, const int* sd,
                                            int* x, int* ts, int* dec,
                                            int* drd, unsigned* dnb) {
  constexpr unsigned kFull = 0xffffffffu;
  int decided = 0;
#pragma unroll 4
  for (int c = 0; c < q.nw; ++c) {
    const unsigned dw = dnb[c];
    const int j = c * 32 + q.lane;
    const bool link =
        cm_c & (!q.sided | (sd[j] == q.side_c)) &
        lv_keep<kHash>(q, (uint32_t)j * (uint32_t)q.n + (uint32_t)q.coord);
    const bool got = (!bit(dw, q.lane)) & ((j == q.coord) | link);
    if (!kDecide) {
      if (got) {
        x[j] = vote_c;
        ts[j] = q.phase;
      }
    } else {
      // every lane read dw before the ballot, so lane 0 may write it
      const unsigned g = __ballot_sync(kFull, got);
      if (got) {
        dec[j] = vote_c;
        drd[j] = r;
      }
      if (q.lane == 0) dnb[c] = dw | g;
      decided += __popc(g);
    }
  }
  return decided;
}

__global__ void __launch_bounds__(32 * kMaxWarps) lv_loop_kernel(LvParams p) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = blockIdx.x * (blockDim.x >> 5) + warp;
  if (s >= p.S) return;
  const int n = p.n;
  const int np = lv_pad(n);
  const int nw = np / 32;
  int* x = smem + (size_t)warp * lv_ints(n);  // [np] estimate
  int* ts = x + np;      // [np] phase of adoption, -1 initially
  int* vote = ts + np;   // [np] the proposal, set at the coordinator
  int* dec = vote + np;  // [np] decision, -1 until decided
  int* drd = dec + np;   // [np] decided_round
  int* sd = drd + np;    // [np] partition side
  unsigned* dnb = reinterpret_cast<unsigned*>(sd + np);  // [nw] done
  unsigned* crb = dnb + nw;                              // [nw] crash set

  const size_t base = (size_t)s * n;
  // the loads first, with no warp vote between them so they overlap (the
  // crash set passes through dec on its way to its bits)
#pragma unroll 8
  for (int c = 0; c < nw; ++c) {
    const int i = c * 32 + lane;
    const bool in = i < n;
    x[i] = in ? p.x0[base + i] : 0;
    sd[i] = in ? p.side[base + i] : 0;
    dec[i] = in ? p.crashed[base + i] : 0;
  }
  for (int c = 0; c < nw; ++c) {
    const int i = c * 32 + lane;
    const unsigned cw = __ballot_sync(kFull, dec[i] != 0);
    // padded lanes count as done: they never send, receive or decide
    const unsigned pad = __ballot_sync(kFull, i >= n);
    if (lane == 0) {
      crb[c] = cw;
      dnb[c] = pad;
    }
    ts[i] = -1;
    vote[i] = 0;
    dec[i] = -1;
    drd[i] = -1;
  }
  __syncwarp();
  const int cr = p.crash_round[s];
  const int hr = p.heal_round[s];
  const int rot = p.rotate_down[s];
  const int p8 = p.p8[s];
  const uint32_t s0 = (uint32_t)p.salt0[s];
  const int s1 = p.salt1[s];
  const int period = rot > 1 ? rot : 1;
  const int half = n / 2;

  int live = n;                        // lanes not done
  bool commit = false, ready = false;  // flags of lane `flagged`
  int flagged = 0;
  LvRound q;
  q.n = n;
  q.nw = nw;
  q.lane = lane;
  q.rot = rot;
  q.p8 = p8;
  q.s0 = s0;
  const bool hashing = p8 > 0 && p8 < 256;

  for (int r = 0; r < p.rounds && live > 0; ++r) {
    const int k = r & 3;
    // a phase starts with both flags clear; with at most n/2 lanes left no
    // collect or ack reaches a majority, so no flag is set again and no
    // lane changes for the rest of the run
    if (k == 0 && r > 0 && live <= half) break;
    q.phase = r >> 2;
    q.coord = q.phase % n;
    q.victim = (r / period) % n;
    q.sided = r < hr;
    q.crashing = r >= cr;
    q.s1r = rt_salt1r(r, s1);
    // the coordinator's scalars, from the state before this round
    const int coord = q.coord;
    const bool act_c = !bit(dnb[coord >> 5], coord & 31);
    q.side_c = q.sided ? sd[coord] : 0;

    if (k == 0 || k == 2) {
      // collect / ack: sender i's message to the coordinator
      int cnt = 0;
      unsigned best = 0;  // 0: no sender; a sender's key is at least n
      if (k == 0) {
        if (hashing) lv_collect<true, false>(q, ts, sd, dnb, crb, cnt, best);
        else lv_collect<false, false>(q, ts, sd, dnb, crb, cnt, best);
      } else {
        if (hashing) lv_collect<true, true>(q, ts, sd, dnb, crb, cnt, best);
        else lv_collect<false, true>(q, ts, sd, dnb, crb, cnt, best);
      }
      // act_c and r are the same in every lane, and so is have
      const int have = __reduce_add_sync(kFull, cnt);
      if (act_c && k == 0 && (have > half || (r == 0 && have > 0))) {
        best = __reduce_max_sync(kFull, best);
        const int bi = n - 1 - (int)(best % (unsigned)n);
        if (lane == 0) vote[coord] = x[bi];
        commit = true;
        flagged = coord;
      } else if (act_c && k == 2 && have > half) {
        ready = true;
        flagged = coord;
      }
    } else if (act_c && (k == 1 ? commit : ready)) {
      // propose / decide: the coordinator's broadcast to receiver j
      const int vote_c = vote[coord];
      const bool cm_c = !(q.crashing && bit(crb[coord >> 5], coord & 31)) &&
                        !(rot > 0 && coord == q.victim);
      if (k == 1) {
        if (hashing)
          lv_broadcast<true, false>(q, cm_c, vote_c, r, sd, x, ts, dec, drd,
                                    dnb);
        else
          lv_broadcast<false, false>(q, cm_c, vote_c, r, sd, x, ts, dec, drd,
                                     dnb);
      } else {
        live -= hashing ? lv_broadcast<true, true>(q, cm_c, vote_c, r, sd, x,
                                                   ts, dec, drd, dnb)
                        : lv_broadcast<false, true>(q, cm_c, vote_c, r, sd,
                                                    x, ts, dec, drd, dnb);
      }
    }
    if (k == 3) commit = ready = false;
    __syncwarp();
  }

  // the final state, coalesced; decided is the done mask
  int* out = p.out;
  const size_t plane = (size_t)p.S * n;
#pragma unroll 2
  for (int c = 0; c < nw; ++c) {
    const int i = c * 32 + lane;
    if (i >= n) break;
    const size_t o = base + i;
    const int dn = bit(dnb[c], lane);
    const bool fl = i == flagged;
    out[o] = x[i];
    out[plane + o] = ts[i];
    out[2 * plane + o] = ready && fl;
    out[3 * plane + o] = commit && fl;
    out[4 * plane + o] = vote[i];
    out[5 * plane + o] = dn;
    out[6 * plane + o] = dec[i];
    out[7 * plane + o] = dn;
    out[8 * plane + o] = drd[i];
  }
}

// Scenarios a block at width n: up to kMaxWarps, as many as fit.
int lv_warps(int n) {
  const size_t per = sizeof(int) * lv_ints(n);
  const size_t fit = (size_t)kMaxSmem / per;
  return fit >= (size_t)kMaxWarps ? kMaxWarps : (int)fit;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one scenario needs (a block holds up to
// four); the launch refuses a width where one does not fit.
size_t lv_loop_smem_bytes(int n) { return sizeof(int) * lv_ints(n); }

// Inputs in lv_loop's order: x0 ([S, n] int32), crashed ([S, n] bool, a
// byte each), side ([S, n] int32), crash_round, heal_round, rotate_down,
// p8, salt0, salt1 ([S] int32);
// `out` is the [9, S, n] int32 outputs in lv_loop's order.  Launches on
// `stream` of `device` and returns cudaGetLastError().
int lv_loop_launch(const int* x0, const uint8_t* crashed, const int* side,
                   const int* crash_round, const int* heal_round,
                   const int* rotate_down, const int* p8, const int* salt0,
                   const int* salt1, int* out, int S, int n, int rounds,
                   int device, void* stream) {
  if (S <= 0 || n <= 0) return (int)cudaSuccess;
  const int warps = lv_warps(n);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const RtDevice on(device);
  if (on.error() != cudaSuccess) return (int)on.error();
  const size_t smem = (size_t)warps * lv_loop_smem_bytes(n);
  static RtSmemLimit limit;
  cudaError_t err = limit.raise(lv_loop_kernel, device, smem);
  if (err != cudaSuccess) return (int)err;
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
  p.out = out;
  p.S = S;
  p.n = n;
  p.rounds = rounds;
  const int blocks = (S + warps - 1) / warps;
  lv_loop_kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
