// K2: the fused masked exchange + per-value histogram of one round.
//
// Replaces round_tpu/ops/fused.py::_kernel (reached through hist_exchange,
// pl.pallas_call at fused.py:293) and the TPU wrapper's passes around it.
// For every scenario s, value v and receiver j:
//
//   counts[s, v, j] = rowmask[j] * (#{ i != j : sender[i] && vals[i] == v
//                                         && side[i] == side[j]
//                                         && keep(j * n + i) }
//                                   + (active[j] && vals[j] == v))
//
//   sender[i] = colmask[i] && active[i] && p8 < 256
//
// with keep the link draw of hash.cuh: the hash-mode fmix32 draw, or with
// hw != 0 the hw-mode Philox4x32-10 stream (round_tpu's hardware-PRNG
// branch of _keep_mask, fused.py:333-346).  As in the TPU wrapper, senders
// of p8 >= 256 scenarios are silenced (a total blackout) and every active
// receiver the row mask selects hears itself (the self-delivery diagonal,
// whatever p8).  The kernel forms the sender mask while it builds the
// one-hot and adds the diagonal as it stores: active, colmask and rowmask
// are read as bool bytes, and the counts are written as int32, so no pass
// over [S, V, n] runs outside the launch
// (round_tpu_torch/ops/fused.py::hist_exchange_counts).
//
// Bound on the card: the draws.  Every link of every 0 < p8 < 256 scenario
// needs its draw (hash: a murmur3 finalizer, at least 9 integer operations
// with the round salt folded into its first xor and its last step made on
// four packed draws at once, split over the ALU and FMA pipes; hw: 1/16 of
// a Philox call, 19 LOP3 and 18 multiplies) and a quarter of a SWAR keep
// compare; it reads O(S*n) inputs and writes O(S*V*n) counts, which at the
// main-path shape take an eighth of the hash draws' time and a third of
// the hw draws'.  The draw loop issues
// about 4.25 (hw) and 9.8 (hash) SASS instructions a link (python -m
// round_tpu_torch.tools.sass_links).
//
// Design: the count is a matrix product on the tensor cores, as round_tpu's
// _count_dot (fused.py:113, used at :211), through count_mma.cuh.  Grid
// (S, ceil(n / 256)), eight warps a block, each warp 32 consecutive
// receivers as two 16-row tiles.  The block writes the sender one-hot of
// up to 16 values as bytes in shared memory (row v: the senders with
// vals[i] == v), 2048 senders at a time, with a flag per 64 senders that
// holds any sender; for every flagged 64-sender block each lane draws the
// 16 links of each of its four receivers straight into keep bytes (one
// Philox call in hw mode, two where n % 16 != 0), masks the other side's
// senders where the scenario's sides differ, and issues mma.sync m16n8k32
// u8 products against the one-hot bytes it loaded once for both tiles.  The
// receiver's own link is taken out after the product.  The count of a
// block is count_mma.cuh's rt_count, which K1 calls too.  A scenario that
// keeps every link (p8 <= 0) needs no product: its counts are the totals
// of the senders on the receiver's side (up to kMaxSides sides); one
// blacked out (p8 >= 256) counts nothing.  Counts
// stay in registers across the sender chunks; values past 16 take another
// pass.  The mask never exists in memory.
#include <cuda_runtime.h>

#include "count_mma.cuh"
#include "launch.cuh"
#include "hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;  // at most 128 registers a thread: no spills
constexpr int kWarps = kThreads / 32;
constexpr int kRecv = 32 * kWarps;  // receivers a block
constexpr int kTiles = 2;           // value tiles a pass: 16 values
constexpr int kChunk = 2048;        // senders a one-hot chunk

// Sender positions of a chunk (a multiple of 64).
__host__ __device__ __forceinline__ int chunk_of(int n) {
  const int kpad = rt_kpad(n);
  return kpad < kChunk ? kpad : kChunk;
}

// Shared memory: the one-hot [16][pitch] bytes, then int sides [chunk] and
// sender-block flags [chunk / 64].
__host__ __device__ __forceinline__ size_t smem_of(int n) {
  const int kc = chunk_of(n);
  return (size_t)kTiles * 8 * rt_oh_pitch(kc) + sizeof(int) * (kc + kc / 64);
}

template <bool kHw>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    hist_exchange_kernel(const int* __restrict__ vals,
                         const uint8_t* __restrict__ active,
                         const uint8_t* __restrict__ colmask,
                         const uint8_t* __restrict__ rowmask,
                         const int* __restrict__ side,
                         const int* __restrict__ salt0,
                         const int* __restrict__ salt1r,
                         const int* __restrict__ p8s, int* __restrict__ out,
                         int n, int V) {
  extern __shared__ __align__(16) int smem[];
  const int kc = chunk_of(n);
  const int pitch = rt_oh_pitch(kc);
  uint8_t* oh = reinterpret_cast<uint8_t*>(smem);          // [16][pitch]
  int* sd = smem + kTiles * 8 * pitch / 4;                 // [kc] sides
  int* blk = sd + kc;                                      // [kc / 64]
  __shared__ int tot[rt_kMaxSides][8 * kTiles];  // senders per side, value
  __shared__ int side_slot[256];
  const int ohq = kTiles * 8 * pitch / 16;

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)s * n;
  const int j0 = blockIdx.y * kRecv + warp * 32;  // the warp's receivers

  // a scenario whose lanes share one side has no partition to test
  int same = 1;
  if (side != nullptr) {
    const int side0 = side[base];
    for (int i = tid; i < n; i += kThreads) same &= side[base + i] == side0;
  }
  const bool split = !__syncthreads_and(same);
  // at most kMaxSides sides: the rounds that keep every link count by side
  const bool slotted = split && rt_side_slots(side + base, side_slot, nullptr,
                                              n, tid, kThreads);
  const int p8 = p8s[s];
  const RtKeepStream ls((uint32_t)salt0[s], (uint32_t)salt1r[s], p8, kHw);
  // a total blackout silences every sender: no count, self-delivery only
  const bool silent = p8 >= 256;
  // every link kept: the counts are the totals of the senders on the
  // receiver's side
  const bool totals = !silent && !ls.draw && (!split || slotted);

  int jr[2][2], jc[2][2], sj[2][2], own[2][2], val[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + m * 16 + h * 8 + g;
      jr[m][h] = j < n ? j : -1;
      jc[m][h] = j < n ? j : n - 1;
      const int jj = jc[m][h];
      sj[m][h] = split ? side[base + jj] : 0;
      if (totals && split) sj[m][h] = side_slot[sj[m][h] & 0xFF];  // slot
      // the receiver's value where it is active and hears itself (the
      // self-delivery diagonal, whatever p8), else -1, which counts nowhere
      const int act = active[base + jj];
      val[m][h] = act ? vals[base + jj] : -1;
      // the receiver's own link, counted by the product and taken out
      own[m][h] = !silent && (colmask[base + jj] & act) != 0 &&
                  ls.keep1<kHw>((uint32_t)jj * (uint32_t)n + (uint32_t)jj);
    }
  const bool live0 = j0 < n, two = j0 + 16 < n;  // the tiles have a row

  for (int v0 = 0; v0 < V; v0 += 8 * kTiles) {
    int c[2][kTiles][4] = {};
    if (totals) {
      __syncthreads();  // the previous pass's readers are done
      for (int q = tid; q < rt_kMaxSides * 8 * kTiles; q += kThreads)
        (&tot[0][0])[q] = 0;
      __syncthreads();
      for (int i = tid; i < n; i += kThreads) {
        const int v = vals[base + i] - v0;
        if ((colmask[base + i] & active[base + i]) != 0 &&
            (unsigned)v < (unsigned)(8 * kTiles) && v0 + v < V)
          atomicAdd(&tot[split ? side_slot[side[base + i] & 0xFF] : 0][v],
                    1);
      }
      __syncthreads();
      const int* trow[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) trow[m][h] = tot[split ? sj[m][h] : 0];
      rt_fill_totals<kTiles>(c, trow, kTiles, t);
    }
    for (int k0 = 0; !totals && !silent && k0 < n; k0 += kc) {
      // the chunk's one-hot of values v0 .. v0+15, its sides and flags
      __syncthreads();  // the previous chunk's readers are done
      uint4* oz = reinterpret_cast<uint4*>(oh);
      for (int q = tid; q < ohq; q += kThreads) oz[q] = make_uint4(0, 0, 0, 0);
      for (int q = tid; q < kc / 64; q += kThreads) blk[q] = 0;
      __syncthreads();
      for (int i = tid; i < kc; i += kThreads) {
        const int gi = k0 + i;
        if (split) sd[i] = gi < n ? side[base + gi] : 0;
        if (gi < n) {
          // the three loads issue together: a sender is in the column mask
          // and active
          const int sends = colmask[base + gi] & active[base + gi];
          const int v = vals[base + gi] - v0;
          if (sends && (unsigned)v < (unsigned)(8 * kTiles) && v0 + v < V) {
            oh[v * pitch + i] = 1;
            blk[i >> 6] = 1;
          }
        }
      }
      __syncthreads();
      if (!live0) continue;
      uint32_t row[2][2];  // the links of the chunk's first sender
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          row[m][h] = (uint32_t)jc[m][h] * (uint32_t)n + (uint32_t)k0;
      rt_count<kTiles, kHw>(c, ls, n, split, row, sj, two, oh, pitch, kTiles,
                            blk, kc / 64, sd, g, t);
    }
    // lane (g, t) holds receivers jr[m][h], values v0 + nt * 8 + 2t + e
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = jr[m][h];
        if (j < 0) continue;
        const bool rm = rowmask == nullptr || rowmask[base + j] != 0;
#pragma unroll
        for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int v = v0 + nt * 8 + 2 * t + e;
            // self-delivery (Round.scala:114-117): v == val[m][h]
            const int cnt =
                rt_less_own(c[m][nt][2 * h + e], v, own[m][h], val[m][h]) +
                (v == val[m][h] ? 1 : 0);
            if (v < V) out[((size_t)s * V + v) * n + j] = rm ? cnt : 0;
          }
      }
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
size_t hist_exchange_smem_bytes(int n, int V) {
  (void)V;  // values past 16 take another pass, not more memory
  return smem_of(n);
}

// Launch on `stream` of `device`: active, colmask and rowmask are [S, n]
// bool bytes, rowmask and side may be null; hw != 0 draws the links from
// the hw-mode Philox stream.  Returns cudaGetLastError().
int hist_exchange_launch(const int* vals, const uint8_t* active,
                         const uint8_t* colmask, const uint8_t* rowmask,
                         const int* side, const int* salt0, const int* salt1r,
                         const int* p8, int* out, int S, int n, int V, int hw,
                         int device, void* stream) {
  if (S <= 0 || n <= 0) return (int)cudaSuccess;
  const RtDevice on(device);
  if (on.error() != cudaSuccess) return (int)on.error();
  const size_t smem = hist_exchange_smem_bytes(n, V);
  static RtSmemLimit limit_hash, limit_hw;
  auto kernel = hw ? hist_exchange_kernel<true> : hist_exchange_kernel<false>;
  const cudaError_t err =
      (hw ? limit_hw : limit_hash).raise(kernel, device, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S, (n + kRecv - 1) / kRecv);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      vals, active, colmask, rowmask, side, salt0, salt1r, p8, out, n, V);
  return (int)cudaGetLastError();
}

}  // extern "C"
