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
// Each instance comes in two link streams, a kernel template switch:
// hash mode (keep(idx) = fmix32 draw >= p8, bit-exact with round_tpu) and
// hw mode (round_tpu's hardware PRNG draw, fused.py:333-346, as the
// Philox4x32-10 stream of hash.cuh: keep(idx) = byte idx & 3 of word
// (idx >> 2) & 3 of counter idx >> 4 >= min(p8, 255)).
//
// Bound on the card: the draws where 0 < p8 < 256.  Every link of such a
// scenario's rounds needs its draw: in hash mode one murmur3 finalizer (at
// least 9 integer operations with the round salt folded into its first xor
// and its last step made on four packed draws at once, split over the ALU
// and FMA pipes, which run alongside), in hw mode 1/16 of a Philox call (19
// LOP3 on the ALU pipe, 18 multiplies on the FMA pipe), and a quarter of a
// SWAR keep compare (3 operations a word of four draws at least; the
// kernels make 4).  A p8 == 0 run draws nothing and reads O(S*n) inputs and
// writes O(S*n) outputs: it is bound by bytes.  With the count on the
// tensor cores the draw loop issues about 4.2 (hw) and 9.9 (hash) SASS
// instructions a link (python -m round_tpu_torch.tools.sass_links),
// against about 35 and 27 for a walk that counts each link on the CUDA
// cores.
//
// Design.  One block per scenario; the state vectors live in shared memory
// for the whole run and only the final state is written out; the round
// loop ends once every lane of the scenario is done.  OTR and Ben-Or count
// on the tensor cores (count_mma.cuh), as round_tpu counts with one matrix
// product (_count_dot, fused.py:113):
//   - each round the block writes the sender one-hot as bytes (row v: the
//     senders whose payload is v; for OTR, whose size counts every sender,
//     row V holds the senders whose payload is outside [0, V), the ones
//     row of fused.py:577 less the rows it duplicates, and is in use only
//     in rounds that have such a sender), with a flag per 64 senders that
//     holds any sender; it compacts the receivers still active into a list
//     and notes each sender's own-link verdict;
//   - a warp takes 32 listed receivers (two 16-row tiles) at a time; for
//     every 64-sender block with a sender, each lane draws the 16 links of
//     each of its four receivers straight into keep bytes (one Philox call
//     in hw mode, two where n % 16 != 0), masks the other side's senders in
//     sided rounds of a split scenario, and issues mma.sync m16n8k32 u8
//     products against the one-hot bytes it loaded once for both tiles;
//   - a round that keeps every link (p8 <= 0) needs no product: the counts
//     are the row totals of the senders on the receiver's side (up to
//     kMaxSides sides, else the product with the side mask, about 5x the
//     time on the flagship's partition family: chip_smoke.py K1-totals);
//   - the block count is count_mma.cuh's rt_count, which K2 calls too;
//   - the lanes of a receiver take its own link out of its row, add the
//     self-delivery, merge their value columns with two shuffles (OTR: the
//     most-often-received value and the size; Ben-Or: its four counters)
//     and one of them runs the policy's update.
// The n x n mask never exists in memory.  Where the one-hot does not fit
// in shared memory beside the state (large n and V) it lives in device
// memory the wrapper allocates; the code is the same.
//
// FloodMin (min_loop, behind the policy's kMma = false) uses no tensor
// core: a minimum is not a sum.  The TPU kernel reads it off the histogram
// (fused.py:466-470, the smallest value with a count), but a count product
// over V = 1000 one-hot rows costs far more than a reduction over the
// senders.  Its block follows n: a group of 1, 2, 4 or 8 warps per
// scenario (the fewest that hold n lanes), as many scenarios as fill 256
// threads.  A receiver's new x is min(x, min of the delivered payloads in
// [0, V)); the self-delivery and the receiver's own link carry its own x
// and cannot lower that, so its own link need not be taken out.
//   - a round that keeps every link (p8 <= 0), or has no sender (p8 >=
//     256): every receiver on a side gets the same minimum, so the group
//     takes it once per side, O(n) a round instead of O(n^2): a
//     __reduce_min_sync over each warp's senders per side slot, then one
//     shared atomicMin per warp and slot.  The slots come from the
//     group's own numbering of its sides (fm_side_slots, up to
//     rt_kMaxSides); a scenario with more sides takes the chunked path
//     below with every link kept;
//   - a round that draws (0 < p8 < 256): a receiver's senders are split
//     across lanes in aligned chunks of 16; RtKeepStream::keep16 gives a
//     chunk's keep bytes (one Philox call in hw mode, two where n % 16 !=
//     0; 16 hashes in hash mode), masked by side in sided rounds, and the
//     lane takes the minimum of the kept payloads (stored chunk-major, so
//     the lanes' loads hit distinct banks); a shuffle minimum over the
//     receiver's lanes ends it, and a pass of a thread a receiver then
//     runs the updates;
//   - done lanes are frozen, decide when r > f (every lane alike, so every
//     lane exits in round f + 1) and decided_round is kept.
#include <cuda_runtime.h>

#include "count_mma.cuh"
#include "hash.cuh"
#include "launch.cuh"

// The block's dynamic shared memory.  The policy state is reached through
// int offsets into it rather than through pointers kept in structs, so
// every access is plainly a shared-memory one.
extern __shared__ __align__(16) int smem[];

namespace {

struct LoopParams {
  const int* x0;
  const uint8_t* crashed;  // [S, n] bool
  const int* side;
  const int* crash_round;
  const int* heal_round;
  const int* rotate_down;
  const int* p8;
  const int* salt0;
  const int* salt1;
  int* out;        // [K + 2][S][n]: the policy's state slots, then done,
                   // decided_round
  uint8_t* onehot;  // [S][onehot_bytes] when the one-hot is not in smem
  int S;
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
  static constexpr bool kMma = true;
  // the size also counts senders whose payload is outside [0, V): they
  // get row V of the one-hot, present only in rounds that have them
  static constexpr bool kOnes = true;
  static constexpr int kTiles = 2;  // value tiles a pass (V <= 16: one)
  // 16 warps an SM, at most 128 registers a thread: at 80 (three blocks)
  // the draw loop spilled
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = 2;
  struct Acc {
    int c, v;  // the most-often-received value v and its count c
    int size;  // the mailbox size: every column
  };

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
  __device__ static void reset(Acc& a, const RoundInfo& ri) {
    a.c = -1;
    a.v = ri.V;
    a.size = 0;
  }
  // count c of column v; the smallest value among the most-often-received
  __device__ static void add_count(Acc& a, const RoundInfo& ri, int v,
                                   int c) {
    if (v < ri.V && (c > a.c || (c == a.c && v < a.v))) {
      a.c = c;
      a.v = v;
    }
    if (v <= ri.V) a.size += c;
  }
  __device__ static void merge(Acc& a, int lane_xor) {
    const int c = __shfl_xor_sync(~0u, a.c, lane_xor);
    const int v = __shfl_xor_sync(~0u, a.v, lane_xor);
    a.size += __shfl_xor_sync(~0u, a.size, lane_xor);
    if (c > a.c || (c == a.c && v < a.v)) {
      a.c = c;
      a.v = v;
    }
  }
  __device__ static bool update(const State<kState>& st, int j, const Acc& a,
                                const RoundInfo& ri, int size) {
    const int bestc = a.c, bestv = a.v;
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
  static constexpr bool kMma = false;  // a running minimum, no histogram
  // 256 threads: one scenario of 8 warps, up to eight of one warp; at most
  // 80 registers a thread, three blocks an SM (at 64 the hash draw spilled)
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = 3;
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
  static constexpr bool kMma = true;
  static constexpr bool kOnes = false;  // the update reads no size: no row V
  static constexpr int kTiles = 1;      // four codes, one value tile
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = 2;
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
  __device__ static void add_count(Acc& a, const RoundInfo&, int v, int c) {
    a.c0 += v == 0 ? c : 0;
    a.c1 += v == 1 ? c : 0;
    a.c2 += v == 2 ? c : 0;
    a.c3 += v == 3 ? c : 0;
  }
  __device__ static void merge(Acc& a, int lane_xor) {
    a.c0 += __shfl_xor_sync(~0u, a.c0, lane_xor);
    a.c1 += __shfl_xor_sync(~0u, a.c1, lane_xor);
    a.c2 += __shfl_xor_sync(~0u, a.c2, lane_xor);
    a.c3 += __shfl_xor_sync(~0u, a.c3, lane_xor);
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

// -- shared memory -----------------------------------------------------------

// The tensor-core instances: ints [side (kpad) | K state | decided_round |
// receiver list | row totals (kMaxSides x rows) | sender-block flags (kpad
// / 64)], bytes [crashed | done | own-link verdict | side slot] (n each),
// then the one-hot bytes [rows][pitch] unless they live in device memory.
// It never takes more shared memory than a receiver walk with a [V][512]
// count array would (40n + 2048V bytes for OTR, 44n for Ben-Or), the
// wrappers' limit for these instances.
template <class A>
struct MmaLayout {
  int n, kpad, nkb, pitch, rows;
  __host__ __device__ MmaLayout(int n_, int V) : n(n_) {
    kpad = rt_kpad(n);
    nkb = kpad / 64;
    pitch = rt_oh_pitch(kpad);
    rows = (V + (A::kOnes ? 1 : 0) + 7) / 8 * 8;
  }
  __host__ __device__ size_t ints() const {
    const size_t k = (size_t)kpad + (size_t)(2 + A::kState) * n +
                     (size_t)rt_kMaxSides * rows + nkb + n;  // n: the bytes
    return (k + 3) / 4 * 4;  // the one-hot starts 16-byte aligned
  }
  __host__ __device__ size_t onehot_bytes() const {
    return (size_t)rows * pitch;
  }
};

// FloodMin's groups: 1, 2, 4 or 8 warps a scenario, the fewest that hold n
// lanes, and 256 / (32 * warps) scenarios a block.  A scenario's ints, each
// array padded to whole warps (np lanes): K state | done | decided_round |
// side | crash set | this round's sender payloads | side slot | mailbox
// minimum (np each), then the per-side minima of two rounds, the side
// values and the number of slots (32).  np is a multiple of 32, so every
// array and every group starts 16-byte aligned.  Sides and payloads are
// stored chunk-major (fm_swz) for the chunked walk's loads.
__host__ __device__ __forceinline__ int fm_group_warps(int n) {
  const int w = (n + 31) / 32;
  return w <= 1 ? 1 : w <= 2 ? 2 : w <= 4 ? 4 : 8;
}
__host__ __device__ __forceinline__ int fm_pad(int n) {
  return (n + 31) / 32 * 32;
}
template <class A>
__host__ __device__ __forceinline__ size_t fm_ints(int n) {
  return (size_t)(A::kState + 7) * fm_pad(n) + 32;
}
template <class A>
__host__ __device__ __forceinline__ int fm_scenarios(int n) {
  return A::kThreads / (32 * fm_group_warps(n));
}
// Where sender i of nc chunks of 16 sits: word q = (i >> 2) & 3 of chunk
// c = i >> 4 at int4 q * nc + c, so the lanes of a warp that read word q of
// consecutive chunks read consecutive 16 bytes (no bank conflict).
__host__ __device__ __forceinline__ int fm_swz(int i, int nc) {
  return ((((i >> 2) & 3) * nc + (i >> 4)) << 2) | (i & 3);
}

template <class A>
size_t smem_bytes(int n, int V, bool onehot_in_smem) {
  if constexpr (A::kMma) {
    const MmaLayout<A> L(n, V);
    return sizeof(int) * L.ints() + (onehot_in_smem ? L.onehot_bytes() : 0);
  } else {
    return sizeof(int) * fm_ints<A>(n) * fm_scenarios<A>(n);
  }
}

template <class A>
size_t onehot_bytes(int n, int V) {
  if constexpr (A::kMma) return MmaLayout<A>(n, V).onehot_bytes();
  return 0;
}

// -- the per-side and chunked minimum (FloodMin) -----------------------------

// The least of the payloads v.x .. v.w of four senders whose keep bytes
// (0x80 kept) are the bytes of kw, as unsigned: 0xFFFFFFFF where none is
// kept.  Branch-free, so the caller's 16-byte loads stay whole: PRMT
// replicates a keep byte's top bit into a mask, one LOP3 makes a dropped
// link's payload all ones.
__device__ __forceinline__ unsigned fm_min4(uint32_t kw, const int4& v) {
  const unsigned a = (unsigned)v.x | ~rt_prmt(kw, 0u, 0x8888);
  const unsigned b = (unsigned)v.y | ~rt_prmt(kw, 0u, 0x9999);
  const unsigned c = (unsigned)v.z | ~rt_prmt(kw, 0u, 0xAAAA);
  const unsigned d = (unsigned)v.w | ~rt_prmt(kw, 0u, 0xBBBB);
  return umin(umin(a, b), umin(c, d));
}

// The minimum of receiver j's kept links over its chunks c = cl, cl + G,
// ... < nc (senders 16c .. 16c + 15, links row + 16c ..): pay holds each
// sender's payload chunk-major (fm_swz), or V where it sends nothing or
// its payload is outside [0, V) (padded lanes too), sd the sides alike.
// kDraw: the links need their draws (else every link is kept); kSided:
// keep only senders on side sj; kAligned: n % 16 == 0.
template <bool kHw, bool kDraw, bool kSided, bool kAligned>
__device__ __forceinline__ int fm_chunks(const RtKeepStream& ls, uint32_t row,
                                         const int4* pay, const int4* sd,
                                         int sj, int cl, int G, int nc,
                                         int V) {
  unsigned m = (unsigned)V;  // payloads and V are >= 0
#pragma unroll 2
  for (int c = cl; c < nc; c += G) {
    uint4 kk = kDraw ? ls.keep16<kHw, kAligned>(row + 16u * (uint32_t)c)
                     : make_uint4(RT_KEEP_ALL, RT_KEEP_ALL, RT_KEEP_ALL,
                                  RT_KEEP_ALL);
    if (kSided) {
      kk.x &= rt_same_side(sd[c], sj);
      kk.y &= rt_same_side(sd[nc + c], sj);
      kk.z &= rt_same_side(sd[2 * nc + c], sj);
      kk.w &= rt_same_side(sd[3 * nc + c], sj);
    }
    const int4 p0 = pay[c], p1 = pay[nc + c], p2 = pay[2 * nc + c],
               p3 = pay[3 * nc + c];
    m = umin(m, umin(umin(fm_min4(kk.x, p0), fm_min4(kk.y, p1)),
                     umin(fm_min4(kk.z, p2), fm_min4(kk.w, p3))));
  }
  return (int)m;
}

// fm_chunks for the round's case: whether its links need draws, whether it
// tests sides and n % 16.  A round that keeps every link and tests no side
// (or has slots for its sides) takes the per-side minimum, never this.
template <bool kHw>
__device__ __forceinline__ int fm_chunks_of(const RtKeepStream& ls,
                                            bool draw, bool sided, int n,
                                            uint32_t row, const int4* pay,
                                            const int4* sd, int sj, int cl,
                                            int G, int nc, int V) {
#define FM_CHUNKS(D, S, A) \
  fm_chunks<kHw, D, S, A>(ls, row, pay, sd, sj, cl, G, nc, V)
  if (!draw) return FM_CHUNKS(false, true, true);
  if ((n & 15) == 0) return sided ? FM_CHUNKS(true, true, true)
                                  : FM_CHUNKS(true, false, true);
  return sided ? FM_CHUNKS(true, true, false) : FM_CHUNKS(true, false, false);
#undef FM_CHUNKS
}

// One warp numbers the distinct sides of the n lanes (lane i's side at
// sdz[fm_swz(i, nc)]) in order of first appearance: slot[i] for each lane,
// sval the side of each slot.  Returns the number of slots, or 0 where
// there are more than rt_kMaxSides sides.
__device__ __forceinline__ int fm_side_slots(const int* sdz, int* slot,
                                             int* sval, int n, int nc,
                                             int lane) {
  constexpr unsigned kFull = 0xffffffffu;
  int ns = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const bool in = i < n;
    const int v = in ? sdz[fm_swz(i, nc)] : 0;
    int q = -1;
    for (int z = 0; z < ns; ++z)
      if (sval[z] == v) q = z;
    unsigned miss = __ballot_sync(kFull, in && q < 0);
    while (miss) {
      if (ns == rt_kMaxSides) return 0;
      const int nv = __shfl_sync(kFull, v, __ffs(miss) - 1);
      if (lane == 0) sval[ns] = nv;
      if (in && v == nv) q = ns;
      ++ns;
      miss = __ballot_sync(kFull, in && q < 0);
    }
    if (in) slot[i] = q;
    __syncwarp();
  }
  return ns;
}

template <class A, bool kHw>
__device__ __forceinline__ void min_loop(const LoopParams& p) {
  constexpr int K = A::kState;
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int kSides = rt_kMaxSides;
  const int n = p.n;
  const int V = p.V;
  const int np = fm_pad(n);
  const int nc = (n + 15) / 16;  // chunks of 16 senders
  const int n16 = 16 * nc;       // lanes of the chunk-major arrays
  const int gw = fm_group_warps(n);  // warps of a scenario
  const int gt = 32 * gw;            // threads of a scenario
  const int grp = threadIdx.x / gt;
  const int t = threadIdx.x % gt;
  const int warp = t >> 5, lane = t & 31;
  const int s = blockIdx.x * fm_scenarios<A>(n) + grp;
  const bool real = s < p.S;  // a group past S runs the barriers only
  const int off = grp * (int)fm_ints<A>(n);
  const State<K> st{off, np};  // K x [np] policy state
  int* dn = smem + off + K * np;  // [np] done (exited); padded lanes 1
  int* drd = dn + np;             // [np] decided_round
  int* sdz = drd + np;            // [n16] partition side, chunk-major
  int* crs = sdz + np;            // [np] crash set
  int* spay = crs + np;           // [n16] sender payloads, chunk-major
  int* slot = spay + np;          // [np] the lane's side slot
  int* mbox = slot + np;          // [np] the receiver's mailbox minimum
  int* smin = mbox + np;          // [2][kSides] per-side minima
  int* sval = smin + 2 * kSides;  // [kSides] the side of each slot
  int* nslots = sval + kSides;    // [1]

  const size_t base = (size_t)s * n;
  for (int i = t; i < np; i += gt) {
    const bool in = real && i < n;
    A::init(st, i, in ? p.x0[base + i] : 0, p.param);
    crs[i] = in && p.crashed[base + i] != 0;
    if (i < n16) {
      sdz[fm_swz(i, nc)] = in ? p.side[base + i] : 0;
      spay[fm_swz(i, nc)] = V;
    }
    dn[i] = !in;
    drd[i] = -1;
    slot[i] = 0;
  }
  if (t < 2 * kSides) smin[t] = V;
  __syncthreads();
  if (warp == 0) {
    const int ns = fm_side_slots(sdz, slot, sval, real ? n : 0, nc, lane);
    if (lane == 0) *nslots = ns;
  }
  __syncthreads();
  // sides: 0 where there are more than kSides (no slots), else how many
  const int ns = real ? *nslots : 1;
  const bool split = ns != 1;
  const int cr = real ? p.crash_round[s] : 0;
  const int hr = real ? p.heal_round[s] : 0;
  const int rot = real ? p.rotate_down[s] : 0;
  const int p8 = real ? p.p8[s] : 0;
  RoundInfo ri;
  ri.n = n;
  ri.V = V;
  ri.param = p.param;
  ri.salt0 = real ? (uint32_t)p.salt0[s] : 0u;
  ri.salt1 = real ? (uint32_t)p.salt1[s] : 0u;
  const int period = rot > 1 ? rot : 1;
  const bool blackout = p8 >= 256;
  int G = 1;  // lanes of a receiver's chunks
  while (G < nc && G < 32) G <<= 1;
  const int per = 32 / G;  // receivers a warp takes at once
  const int sub = lane / G, cl = lane % G;
  const int4* pay4 = reinterpret_cast<const int4*>(spay);
  const int4* sd4 = reinterpret_cast<const int4*>(sdz);

  for (int r = 0; r < p.rounds; ++r) {
    const int victim = (r / period) % n;
    const bool sided = r < hr && split;
    const bool by_side = sided && ns > 0;  // a minimum per side slot
    const int nz = by_side ? ns : 1;       // minima this round
    // no sender, or every link kept with a slot for each side
    const bool totals = blackout || (p8 <= 0 && (!sided || ns > 0));
    const int buf = (r & 1) * kSides;
    ri.r = r;
    ri.k = 0;
    // the senders' payloads: per-side minima, or each one for the chunks
    int any_active = 0;
    int m[kSides];
#pragma unroll
    for (int z = 0; z < kSides; ++z) m[z] = V;
    for (int i0 = warp * 32; i0 < np; i0 += gt) {
      const int i = i0 + lane;
      const bool active = !dn[i];
      any_active |= active;
      const bool sender = active && !(crs[i] && r >= cr) &&
                          !(rot > 0 && i == victim) && !blackout;
      const int x = st(0, i);
      const int v = sender && (unsigned)x < (unsigned)V ? x : V;
      if (totals) {
        const int q = by_side ? slot[i] : 0;
#pragma unroll
        for (int z = 0; z < kSides; ++z)
          if (z < nz) m[z] = min(m[z], __reduce_min_sync(kFull, q == z ? v : V));
      } else if (i < n16) {
        spay[fm_swz(i, nc)] = v;
      }
    }
    if (totals && lane == 0) {
#pragma unroll
      for (int z = 0; z < kSides; ++z)
        if (z < nz && m[z] < V) atomicMin(&smin[buf + z], m[z]);
    }
    // every lane done: the state is frozen for the remaining rounds
    if (!__syncthreads_or(any_active)) break;

    if (!totals) {
      // each receiver's mailbox minimum: a warp takes `per` receivers at a
      // time, G lanes each, then a shuffle minimum over the G lanes
      const RtKeepStream ls(ri.salt0, rt_salt1r(r, (int)ri.salt1), p8, kHw);
      const bool draw = p8 > 0;
      for (int j0 = warp * per; j0 < n; j0 += gw * per) {
        const int j = j0 + sub;
        const bool live = j < n && !dn[j];
        if (!__any_sync(kFull, live)) continue;
        int mj = V;
        if (live)
          mj = fm_chunks_of<kHw>(ls, draw, sided, n,
                                 (uint32_t)j * (uint32_t)n, pay4, sd4,
                                 sided ? sdz[fm_swz(j, nc)] : 0, cl, G, nc,
                                 V);
        if (G == 32) {
          mj = __reduce_min_sync(kFull, mj);
        } else {
          for (int o = G >> 1; o > 0; o >>= 1)
            mj = min(mj, __shfl_xor_sync(kFull, mj, o));
        }
        if (live && cl == 0) mbox[j] = mj;
      }
    }
    // every group of the block, whichever path it took this round
    __syncthreads();
    // the update, a thread a receiver
    for (int j = t; j < n; j += gt) {
      if (dn[j]) continue;
      typename A::Acc acc;
      acc.m = totals ? smin[buf + (by_side ? slot[j] : 0)] : mbox[j];
      A::add(acc, ri, A::payload(st, j, 0));  // the self-delivery
      if (A::update(st, j, acc, ri, 0)) dn[j] = 1;
      if (st(A::kDecided, j) && drd[j] < 0) drd[j] = r;
    }
    // the other round's minima: last read before the previous barrier,
    // next written after the next one
    if (t < kSides) smin[(kSides - buf) + t] = V;
    __syncthreads();
  }

  if (!real) return;
  const size_t plane = (size_t)p.S * n;
  for (int i = t; i < n; i += gt) {
#pragma unroll
    for (int q = 0; q < K; ++q) p.out[q * plane + base + i] = st(q, i);
    p.out[K * plane + base + i] = dn[i];
    p.out[(K + 1) * plane + base + i] = drd[i];
  }
}

// -- the tensor-core count (OTR, Ben-Or) --------------------------------------

template <class A, bool kHw>
__device__ __forceinline__ void mma_loop(const LoopParams& p) {
  constexpr int K = A::kState;
  constexpr int T = A::kTiles;
  constexpr int kThreads = A::kThreads;
  constexpr int kWarps = kThreads / 32;
  const int n = p.n;
  const int V = p.V;
  const MmaLayout<A> L(n, V);
  int* sd = smem;                     // [kpad] partition side
  const State<K> st{L.kpad, n};       // K x [n] policy state
  int* drd = sd + L.kpad + K * n;     // [n] decided_round
  int* rlist = drd + n;               // [n] this round's active receivers
  int* tot = rlist + n;               // [kMaxSides][rows] senders per row
  int* blk = tot + rt_kMaxSides * L.rows;  // [nkb] the block has a sender
  uint8_t* crs = reinterpret_cast<uint8_t*>(blk + L.nkb);  // [n] crash set
  uint8_t* dn = crs + n;              // [n] done (exited)
  uint8_t* dg = dn + n;               // [n] the sender hears itself by link
  uint8_t* ss = dg + n;               // [n] the lane's side slot
  uint8_t* oh = p.onehot != nullptr
                    ? p.onehot + (size_t)blockIdx.x * L.onehot_bytes()
                    : reinterpret_cast<uint8_t*>(smem + L.ints());
  __shared__ int nrecv;
  __shared__ int other;  // a sender's payload is outside [0, V)

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)s * n;
  const int side0 = p.side[base];
  int same = 1;
  for (int i = tid; i < L.kpad; i += kThreads) {
    if (i < n) {
      A::init(st, i, p.x0[base + i], p.param);
      crs[i] = p.crashed[base + i] != 0;
      dn[i] = 0;
      drd[i] = -1;
      sd[i] = p.side[base + i];
      same &= sd[i] == side0;
    } else {
      sd[i] = side0;
    }
  }
  // a scenario whose lanes share one side has no partition to test; one
  // with at most kMaxSides sides has slots for per-side totals
  const bool split = !__syncthreads_and(same);
  __shared__ int side_slot[256];
  const bool slotted =
      split && rt_side_slots(sd, side_slot, ss, n, tid, kThreads);
  const int cr = p.crash_round[s];
  const int hr = p.heal_round[s];
  const int rot = p.rotate_down[s];
  const int p8 = p.p8[s];
  RoundInfo ri;
  ri.n = n;
  ri.V = V;
  ri.param = p.param;
  ri.salt0 = (uint32_t)p.salt0[s];
  ri.salt1 = (uint32_t)p.salt1[s];
  const int period = rot > 1 ? rot : 1;
  const bool blackout = p8 >= 256;
  const int ohq = (int)(L.onehot_bytes() / 16);

  for (int r = 0; r < p.rounds; ++r) {
    const int k = r % A::kPhase;
    const int victim = (r / period) % n;
    const bool sided = r < hr && split;
    const RtKeepStream ls(ri.salt0, rt_salt1r(r, (int)ri.salt1), p8, kHw);
    // every link kept: a receiver's counts are the totals of the senders
    // on its side, less its own link
    const bool totals = !ls.draw && (!sided || slotted);
    ri.r = r;
    ri.k = k;
    // the previous round's readers are past the closing barrier
    if (!totals) {
      uint4* oz = reinterpret_cast<uint4*>(oh);
      for (int q = tid; q < ohq; q += kThreads)
        oz[q] = make_uint4(0, 0, 0, 0);
      for (int q = tid; q < L.nkb; q += kThreads) blk[q] = 0;
    }
    for (int q = tid; q < rt_kMaxSides * L.rows; q += kThreads) tot[q] = 0;
    if (tid == 0) {
      nrecv = 0;
      other = 0;
    }
    __syncthreads();
    // the one-hot of this round's senders, their own links' verdicts, and
    // the active receivers
    int any_active = 0;
    for (int i0 = 0; i0 < n; i0 += kThreads) {
      const int i = i0 + tid;
      bool active = false;
      if (i < n) {
        active = !dn[i];
        const bool alive = !(crs[i] && r >= cr);
        const bool rotated = rot > 0 && i == victim;
        const bool sender = active && alive && !rotated && !blackout;
        if (sender) {
          const int c = A::payload(st, i, k);
          // row c, or row V for a payload outside [0, V) (kOnes)
          const int row = (unsigned)c < (unsigned)V ? c : A::kOnes ? V : -1;
          if (row == V) other = 1;
          if (row >= 0 && totals)
            atomicAdd(&tot[(sided ? ss[i] : 0) * L.rows + row], 1);
          if (row >= 0 && !totals) {
            oh[(size_t)row * L.pitch + i] = 1;
            blk[i >> 6] = 1;
          }
        }
        if (active)
          dg[i] = sender &&
                  ls.keep1<kHw>((uint32_t)i * (uint32_t)n + (uint32_t)i);
      }
      const unsigned act = __ballot_sync(~0u, active);
      int at = 0;
      if (lane == 0 && act) at = atomicAdd(&nrecv, __popc(act));
      at = __shfl_sync(~0u, at, 0);
      if (active) rlist[at + __popc(act & ((1u << lane) - 1u))] = i;
      any_active |= active;
    }
    // every lane done: the state is frozen for the remaining rounds
    if (!__syncthreads_or(any_active)) break;
    const int R = nrecv;
    const int tiles = (V + other + 7) / 8;  // the one-hot rows in use

    // a warp's job: listed receivers 32q .. 32q+31, as two 16-row tiles
    // (m), each a pair of rows g (h = 0) and g + 8 (h = 1)
    for (int q = warp; q * 32 < R; q += kWarps) {
      int jr[2][2], jc[2][2];
      typename A::Acc acc[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = q * 32 + m * 16 + h * 8 + g;
          jr[m][h] = at < R ? rlist[at] : -1;
          jc[m][h] = rlist[at < R ? at : R - 1];
          A::reset(acc[m][h], ri);
        }
      const bool two = q * 32 + 16 < R;  // the second tile has a receiver
      for (int v0 = 0; v0 < tiles; v0 += T) {
        int c[2][T][4] = {};
        if (totals) {
          const int* trow[2][2];
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              trow[m][h] = tot + (sided ? ss[jc[m][h]] : 0) * L.rows + v0 * 8;
          rt_fill_totals<T>(c, trow, tiles - v0, t);
        } else {
          uint32_t row[2][2];
          int sj[2][2];
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              row[m][h] = (uint32_t)jc[m][h] * (uint32_t)n;
              sj[m][h] = sided ? sd[jc[m][h]] : 0;
            }
          rt_count<T, kHw>(c, ls, n, sided, row, sj, two,
                           oh + (size_t)v0 * 8 * L.pitch, L.pitch, tiles - v0,
                           blk, L.nkb, sd, g, t);
        }
        // this lane's value columns: (v0 + nt) * 8 + 2t + e, rows g, g + 8.
        // The receiver hears itself (its payload before the update, which
        // only this job writes) and not over its own link.
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = jc[m][h];
            const int pay = A::payload(st, j, k);
            const bool inr = (unsigned)pay < (unsigned)V;
            const int own = dg[j];
#pragma unroll
            for (int nt = 0; nt < T; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int v = (v0 + nt) * 8 + 2 * t + e;
                // j's own link sits in its payload's row, or OTR's row V
                const int cnt =
                    rt_less_own(c[m][nt][2 * h + e], v, own,
                                inr ? pay : A::kOnes ? V : -1) +
                    (inr && v == pay ? 1 : 0);
                if (v0 + nt < tiles) A::add_count(acc[m][h], ri, v, cnt);
              }
          }
      }
      // merge the four lanes of each receiver; lane t updates pair t
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          A::merge(acc[m][h], 1);
          A::merge(acc[m][h], 2);
          const int j = jr[m][h];
          if (t == 2 * m + h && j >= 0) {
            // the size counts the self-delivery (in its payload's column
            // when that is in [0, V))
            int size = 0;
            if constexpr (A::kOnes)
              size = acc[m][h].size +
                     ((unsigned)A::payload(st, j, k) < (unsigned)V ? 0 : 1);
            if (A::update(st, j, acc[m][h], ri, size)) dn[j] = 1;
            if (st(A::kDecided, j) && drd[j] < 0) drd[j] = r;
          }
        }
    }
    __syncthreads();
  }

  const size_t plane = (size_t)p.S * n;
  for (int i = tid; i < n; i += kThreads) {
#pragma unroll
    for (int q = 0; q < K; ++q) p.out[q * plane + base + i] = st(q, i);
    p.out[K * plane + base + i] = dn[i];
    p.out[(K + 1) * plane + base + i] = drd[i];
  }
}

template <class A, bool kHw>
__global__ void __launch_bounds__(A::kThreads, A::kMinBlocks)
    hist_loop_kernel(LoopParams p) {
  if constexpr (A::kMma)
    mma_loop<A, kHw>(p);
  else
    min_loop<A, kHw>(p);
}

template <class A, bool kHw>
int launch_stream(const LoopParams& p, int device, size_t smem,
                  void* stream) {
  static RtSmemLimit limit;
  const cudaError_t err =
      limit.raise(hist_loop_kernel<A, kHw>, device, smem);
  if (err != cudaSuccess) return (int)err;
  // the tensor-core instances take a block per scenario, FloodMin a block
  // per fm_scenarios
  const int per = A::kMma ? 1 : fm_scenarios<A>(p.n);
  const int blocks = (p.S + per - 1) / per;
  hist_loop_kernel<A, kHw>
      <<<blocks, A::kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <class A>
int launch(const int* const* ins, const uint8_t* crashed, int* out,
           uint8_t* onehot, int S, int n, int V, int rounds, int param,
           int hw, int device, void* stream) {
  if (S <= 0 || n <= 0) return (int)cudaSuccess;
  const RtDevice on(device);
  if (on.error() != cudaSuccess) return (int)on.error();
  LoopParams p;
  p.x0 = ins[0];
  p.crashed = crashed;
  p.side = ins[1];
  p.crash_round = ins[2];
  p.heal_round = ins[3];
  p.rotate_down = ins[4];
  p.p8 = ins[5];
  p.salt0 = ins[6];
  p.salt1 = ins[7];
  p.out = out;
  p.onehot = onehot;
  p.S = S;
  p.n = n;
  p.V = V;
  p.rounds = rounds;
  p.param = param;
  const size_t smem = smem_bytes<A>(n, V, onehot == nullptr);
  return hw ? launch_stream<A, true>(p, device, smem, stream)
            : launch_stream<A, false>(p, device, smem, stream);
}

}  // namespace

// C entry points, one triple per instance.  Inputs in hist_loop's order:
// x0 ([S, n] int32), crashed ([S, n] bool, a byte each), side ([S, n]
// int32), crash_round, heal_round, rotate_down, p8, salt0, salt1 ([S]
// int32).  `out` holds the outputs [K + 2][S][n] int32: the policy's K
// state slots, done, decided_round.  `onehot` is
// null, or S * onehot_bytes bytes of device memory that hold the
// tensor-core instances' one-hot where it does not fit in shared memory
// (smem_bytes(n, V, 1) too large); smem_bytes(n, V, onehot == null) is what
// the launch asks for.  hw != 0 draws the links from the hw-mode Philox
// stream, else from the hash.  Each launch runs on `stream` of `device`
// and returns cudaGetLastError().
extern "C" {

#define RT_LOOP_ENTRY(NAME, POLICY)                                          \
  size_t NAME##_smem_bytes(int n, int V, int onehot_in_smem) {              \
    return smem_bytes<POLICY>(n, V, onehot_in_smem != 0);                   \
  }                                                                          \
  size_t NAME##_onehot_bytes(int n, int V) {                                \
    return onehot_bytes<POLICY>(n, V);                                      \
  }                                                                          \
  int NAME##_launch(const int* x0, const uint8_t* crashed, const int* side, \
                    const int* crash_round, const int* heal_round,          \
                    const int* rotate_down, const int* p8, const int* salt0, \
                    const int* salt1, int* out, uint8_t* onehot, int S,     \
                    int n, int V, int rounds, int param, int hw, int device, \
                    void* stream) {                                          \
    const int* ins[8] = {x0,          side, crash_round, heal_round, \
                         rotate_down, p8,   salt0,       salt1};             \
    return launch<POLICY>(ins, crashed, out, onehot, S, n, V, rounds, param, \
                          hw, device, stream);                               \
  }

RT_LOOP_ENTRY(otr_loop, OtrPolicy)
RT_LOOP_ENTRY(floodmin_loop, FloodMinPolicy)
RT_LOOP_ENTRY(benor_loop, BenOrPolicy)

#undef RT_LOOP_ENTRY

}  // extern "C"
