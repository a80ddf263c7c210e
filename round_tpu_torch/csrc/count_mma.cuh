// The per-value count of K1 and K2 on the tensor cores.
//
// A round's counts are a matrix product over the senders i:
//
//   counts[j, v] = sum_i keep(j, i) * onehot(i, v)
//
// with the keep bits drawn from the link stream (hash.cuh) and the sender
// one-hot built once per round.  Both operands are 0/1 bytes, so one
// mma.sync.aligned.m16n8k32 u8 x u8 -> s32 product counts 16 receivers x
// 8 values over 32 senders exactly.  The keep bytes are 0x80 (the SWAR
// compare leaves the verdict in each byte's top bit), so every product is
// 128 times the count: the callers shift the accumulators right by 7.
//
// Fragments (PTX ISA, "Matrix fragments for mma.m16n8k32", lane = 4 g + t):
//   A (16 x 32 keep, receivers x senders): a0 = row g, cols 4t..4t+3;
//     a1 = row g+8, the same cols; a2 = row g, cols 16+4t..16+4t+3;
//     a3 = row g+8, those cols.
//   B (32 x 8 one-hot, senders x values): b0 = rows 4t..4t+3, col g;
//     b1 = rows 16+4t..16+4t+3, col g.
//   C: c0, c1 = row g, cols 2t, 2t+1; c2, c3 = row g+8, the same cols.
// A lane's K positions are the same in A and B, so any placement of the
// senders on the K axis gives the same sum as long as both operands use
// it.  The placement here: in a block of 64 senders, lane t holds senders
// 16t .. 16t+15, four words of four consecutive senders -- exactly one hw
// Philox call of one receiver -- as (a0, a2) of k-step 0 and (a0, a2) of
// k-step 1.  In the one-hot, those 16 senders are 16 consecutive bytes of
// the value's row, so one 16-byte load gives the lane b0, b1 of both
// k-steps.  No shuffle moves a draw, and the one-hot is stored in plain
// sender order.
#pragma once

#include <stdint.h>

#include "hash.cuh"

#define RT_KEEP_ALL 0x80808080u  // four kept links

// One-hot rows are padded to a multiple of 64 senders, and the row pitch is
// 64 bytes past a multiple of 128, so the 16-byte loads of the eight rows a
// quarter warp touches fall in distinct banks.
__host__ __device__ __forceinline__ int rt_kpad(int n) {
  return (n + 63) / 64 * 64;
}
__host__ __device__ __forceinline__ int rt_oh_pitch(int kpad) {
  return kpad % 128 == 64 ? kpad : kpad + 64;
}

// counts (16 x 8, s32) += keep (16 x 32, u8) * onehot (32 x 8, u8).
__device__ __forceinline__ void rt_mma_u8(int (&c)[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The two k-steps of a 64-sender block for one receiver pair (rows g and
// g+8, keep strings ka and kb) and one value tile (the lane's 16 one-hot
// bytes b).
__device__ __forceinline__ void rt_mma_pair(int (&c)[4], const uint4& ka,
                                            const uint4& kb, const uint4& b) {
  rt_mma_u8(c, ka.x, kb.x, ka.y, kb.y, b.x, b.y);
  rt_mma_u8(c, ka.z, kb.z, ka.w, kb.w, b.z, b.w);
}

// SWAR keep verdict of four 8-bit draws x against the threshold y
// (1 <= y <= 255): byte 0x80 where draw >= y, else 0.  With ylo = (y &
// 0x7F) in every byte, t's top bit per byte is (x & 0x7F) >= (y & 0x7F)
// (128 + x_lo - y_lo never borrows), and x >= y is x7 & t7 when y >= 128,
// x7 | t7 when not: ylt is all ones when y < 128, else 0.  Four operations
// a word; a kernel switched on y < 128 per round would need three.
__device__ __forceinline__ uint32_t rt_keep_bytes(uint32_t x, uint32_t ylo,
                                                  uint32_t ylt) {
  const uint32_t t = (x | 0x80808080u) - ylo;
  return ((x & t) | ((x | t) & ylt)) & 0x80808080u;
}

// PRMT through inline PTX: the compiler's own byte permute is plain shifts
// and masks to it, which it rebuilt into one shift and xor per draw.
__device__ __forceinline__ uint32_t rt_prmt(uint32_t a, uint32_t b,
                                            uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// Byte 0 ^ byte 2 of each of z0 .. z3 (the low byte of fmix32's last step,
// z ^ (z >> 16)), packed into one word, in five operations.
__device__ __forceinline__ uint32_t rt_pack_last(uint32_t z0, uint32_t z1,
                                                 uint32_t z2, uint32_t z3) {
  const uint32_t a = rt_prmt(z0, z1, 0x6240);  // z0.b0 z1.b0 z0.b2 z1.b2
  const uint32_t b = rt_prmt(z2, z3, 0x4062);  // z2.b2 z3.b2 z2.b0 z3.b0
  // (z0.b0 z1.b0 z2.b0 z3.b0) ^ (z0.b2 z1.b2 z2.b2 z3.b2)
  return rt_prmt(a, b, 0x7610) ^ __funnelshift_r(a, b, 16);
}

// Bytes off .. off+15 (off < 16) of the 32-byte string (w, v), as words.
__device__ __forceinline__ uint4 rt_funnel16(const uint4& w, const uint4& v,
                                             uint32_t off) {
  const uint32_t a[8] = {w.x, w.y, w.z, w.w, v.x, v.y, v.z, v.w};
  const bool by8 = (off & 8u) != 0, by4 = (off & 4u) != 0;
  const uint32_t sh = (off & 3u) * 8u;
  uint32_t b[6], c[5];
#pragma unroll
  for (int i = 0; i < 6; ++i) b[i] = by8 ? a[i + 2] : a[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) c[i] = by4 ? b[i + 1] : b[i];
  return make_uint4(__funnelshift_r(c[0], c[1], sh),
                    __funnelshift_r(c[1], c[2], sh),
                    __funnelshift_r(c[2], c[3], sh),
                    __funnelshift_r(c[3], c[4], sh));
}

// The link stream of one (scenario, round) as keep bytes.
struct RtKeepStream {
  uint32_t s0, s1r;
  uint32_t s1f;      // s1r ^ (s1r >> 16): the salt through fmix32's first
                     // shift and xor, which distribute over the xor
  uint32_t ylo;      // threshold & 0x7F in every byte
  uint32_t ylt;      // all ones when the threshold is below 128
  uint32_t y;        // the threshold
  bool draw;         // the links need their draws
  bool fill;         // the verdict of every link when they do not

  // hw keeps draw >= min(p8, 255) and hash draw >= p8; p8 <= 0 keeps
  // every link and, in hash mode, p8 >= 256 none, without a draw.
  __device__ __forceinline__ RtKeepStream(uint32_t salt0, uint32_t salt1r,
                                          int p8, bool hw) {
    s0 = salt0;
    s1r = salt1r;
    s1f = salt1r ^ (salt1r >> 16);
    draw = p8 > 0 && (hw || p8 < 256);
    fill = p8 <= 0;
    y = hw ? rt_hw_threshold(p8) : (uint32_t)(p8 & 0xFF);
    // the byte replicated by PRMT, not a multiply the compiler would fold
    // into each compare as an IMAD on the FMA pipe, which Philox fills
    ylo = __byte_perm(y & 0x7Fu, 0u, 0x0000);
    ylt = y < 128u ? ~0u : 0u;
  }

  // Keep bytes of the 16 drawn links idx0 .. idx0+15 (one receiver, 16
  // consecutive senders): word w byte b is link idx0 + 4w + b.  kAligned:
  // n % 16 == 0, so idx0 is a multiple of 16.
  template <bool kHw, bool kAligned>
  __device__ __forceinline__ uint4 keep16(uint32_t idx0) const {
    uint4 x;
    if (kHw) {
      // link idx draws byte idx & 3 of word (idx >> 2) & 3 of counter
      // idx >> 4: an aligned row reads one call, an unaligned one the
      // bytes idx0 & 15 .. +15 of two calls
      const uint32_t c = idx0 >> 4;
      x = rt_philox4x32_10(make_uint4(c, 0u, 0u, 0u), s0, s1r);
      if (!kAligned)
        x = rt_funnel16(x, rt_philox4x32_10(make_uint4(c + 1u, 0u, 0u, 0u),
                                            s0, s1r),
                        idx0 & 15u);
    } else {
      uint32_t w[4];
      const uint32_t h = idx0 * RT_GOLD + s0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // fmix32 of (link ^ s1r) up to its last step, the salt folded into
        // the first xor; the last step on four packed draws at a time
        uint32_t z[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t k = h + (uint32_t)(4 * q + b) * RT_GOLD;
          uint32_t y = k ^ (k >> 16) ^ s1f;
          y *= 0x85EBCA6Bu;
          y ^= y >> 13;
          z[b] = y * 0xC2B2AE35u;
        }
        w[q] = rt_pack_last(z[0], z[1], z[2], z[3]);
      }
      x = make_uint4(w[0], w[1], w[2], w[3]);
    }
    return make_uint4(rt_keep_bytes(x.x, ylo, ylt),
                      rt_keep_bytes(x.y, ylo, ylt),
                      rt_keep_bytes(x.z, ylo, ylt),
                      rt_keep_bytes(x.w, ylo, ylt));
  }

  // The verdict of the one link idx (the diagonal's, for its correction).
  template <bool kHw>
  __device__ __forceinline__ bool keep1(uint32_t idx) const {
    if (!draw) return fill;
    uint32_t d;
    if (kHw) {
      const uint4 w =
          rt_philox4x32_10(make_uint4(idx >> 4, 0u, 0u, 0u), s0, s1r);
      const uint32_t q = (idx >> 2) & 3u;
      d = ((q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w) >>
           ((idx & 3u) * 8u)) & 0xFFu;
    } else {
      d = rt_link_draw(idx, s0, s1r);
    }
    return d >= y;
  }
};

// Per-side totals: a scenario with at most this many sides counts the
// rounds that keep every link by side, with no product.
constexpr int rt_kMaxSides = 8;

// Give each distinct side of sd[0..n) a slot in [0, kMaxSides): slot
// index[side & 0xFF] (256 ints of the caller's shared memory), also
// written to slot[i] unless slot is null.  The block calls it together
// (nthreads threads, tid this one).  Sides are told apart by their low
// byte, which must then be one-to-one on this scenario's sides.  Returns
// whether every side got a slot; false leaves the slots unspecified.
__device__ __forceinline__ bool rt_side_slots(const int* sd, int* index,
                                              uint8_t* slot, int n, int tid,
                                              int nthreads) {
  __shared__ int value[256];  // a side whose low byte is the index
  __shared__ int count;
  for (int c = tid; c < 256; c += nthreads) index[c] = -1;
  __syncthreads();
  for (int i = tid; i < n; i += nthreads) {
    value[sd[i] & 0xFF] = sd[i];  // any writer wins
    index[sd[i] & 0xFF] = 0;
  }
  __syncthreads();
  int ok = 1;
  for (int i = tid; i < n; i += nthreads) ok &= value[sd[i] & 0xFF] == sd[i];
  if (tid == 0) {
    int k = 0;  // number the marked bytes in order
    for (int c = 0; c < 256; ++c)
      if (index[c] == 0) index[c] = k++;
    count = k;
  }
  ok = __syncthreads_and(ok) && count <= rt_kMaxSides;
  if (ok && slot != nullptr)
    for (int i = tid; i < n; i += nthreads)
      slot[i] = (uint8_t)index[sd[i] & 0xFF];
  __syncthreads();
  return ok;
}

// 0x80 in byte b where side s.b equals sj.
__device__ __forceinline__ uint32_t rt_same_side(const int4& s, int sj) {
  return (s.x == sj ? 0x80u : 0u) | (s.y == sj ? 0x8000u : 0u) |
         (s.z == sj ? 0x800000u : 0u) | (s.w == sj ? 0x80000000u : 0u);
}

// Keep only the links of 16 senders (sides sd[0..15], 16-byte aligned)
// on receiver side sj: the partition test of a sided round.
__device__ __forceinline__ void rt_mask_sides(uint4& k, const int* sd,
                                              int sj) {
  const int4* s4 = reinterpret_cast<const int4*>(sd);
  k.x &= rt_same_side(s4[0], sj);
  k.y &= rt_same_side(s4[1], sj);
  k.z &= rt_same_side(s4[2], sj);
  k.w &= rt_same_side(s4[3], sj);
}

// -- one value pass of a warp ------------------------------------------------

// A warp's two 16-receiver tiles m, each of rows g (h = 0) and g + 8 (h =
// 1), over the 64-sender blocks kb < nkb that hold a sender (blk[kb] != 0):
// c[m][nt] += the keep bytes of links row[m][h] + i (sender i of the
// blocks) times one-hot tile nt (row nt * 8 + g of oh, sender i at byte i;
// tiles nt >= tiles read as zero).  kDraw: the links need their draws (else
// every link is kept); kSided: keep only senders whose side sd[i] is
// sj[m][h]; kAligned: n % 16 == 0.  two: tile 1 has a receiver.  The
// receiver's own link is counted: the callers take it out (rt_less_own).
template <int T, bool kHw, bool kDraw, bool kSided, bool kAligned>
__device__ __forceinline__ void rt_count_blocks(
    int (&c)[2][T][4], const RtKeepStream& ls, const uint32_t (&row)[2][2],
    const int (&sj)[2][2], bool two, const uint8_t* oh, int pitch, int tiles,
    const int* blk, int nkb, const int* sd, int g, int t) {
  for (int kb = 0; kb < nkb; ++kb) {
    if (!blk[kb]) continue;  // no sender: no draw, no product
    const int i0 = kb * 64 + 16 * t;
    uint4 b[T];
#pragma unroll
    for (int nt = 0; nt < T; ++nt)
      b[nt] = nt < tiles ? *reinterpret_cast<const uint4*>(
                               oh + (size_t)(nt * 8 + g) * pitch + i0)
                         : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m == 1 && !two) break;
      uint4 kk[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        kk[h] = kDraw ? ls.keep16<kHw, kAligned>(row[m][h] + (uint32_t)i0)
                      : make_uint4(RT_KEEP_ALL, RT_KEEP_ALL, RT_KEEP_ALL,
                                   RT_KEEP_ALL);
        if (kSided) rt_mask_sides(kk[h], sd + i0, sj[m][h]);
      }
#pragma unroll
      for (int nt = 0; nt < T; ++nt)
        rt_mma_pair(c[m][nt], kk[0], kk[1], b[nt]);
    }
  }
}

// rt_count_blocks for the round's case: whether its links need draws
// (ls.draw), whether it tests sides (sided) and n % 16.  A round that
// keeps every link and tests no side is counted by its totals
// (rt_fill_totals), never here.
template <int T, bool kHw>
__device__ __forceinline__ void rt_count(
    int (&c)[2][T][4], const RtKeepStream& ls, int n, bool sided,
    const uint32_t (&row)[2][2], const int (&sj)[2][2], bool two,
    const uint8_t* oh, int pitch, int tiles, const int* blk, int nkb,
    const int* sd, int g, int t) {
#define RT_COUNT(D, S, A)                                                   \
  rt_count_blocks<T, kHw, D, S, A>(c, ls, row, sj, two, oh, pitch, tiles, \
                                   blk, nkb, sd, g, t)
  if (ls.draw && (n & 15) == 0) {
    if (sided) RT_COUNT(true, true, true);
    else RT_COUNT(true, false, true);
  } else if (ls.draw) {
    if (sided) RT_COUNT(true, true, false);
    else RT_COUNT(true, false, false);
  } else {
    RT_COUNT(false, true, true);
  }
#undef RT_COUNT
}

// The accumulators of a round that keeps every link: receiver (m, h)
// gets the totals trow[m][h][v] of the senders on its side, per value v of
// the pass, as the product would give them (128 x), for tiles nt < tiles.
template <int T>
__device__ __forceinline__ void rt_fill_totals(
    int (&c)[2][T][4], const int* const (&trow)[2][2], int tiles, int t) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < T; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        c[m][nt][e] = nt < tiles
                          ? trow[m][e >> 1][nt * 8 + 2 * t + (e & 1)] << 7
                          : 0;
}

// A receiver's count of value v from its accumulator (128 x the count),
// less its own link where that link was kept (own) and counted in column
// own_v.
__device__ __forceinline__ int rt_less_own(int acc, int v, bool own,
                                           int own_v) {
  return (acc >> 7) - (own && v == own_v ? 1 : 0);
}
