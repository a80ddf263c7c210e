// Shared device helpers of the fault model's two link streams.
//
// Hash mode is bit-exact with round_tpu/ops/fused.py::_fmix32 / _keep_mask
// (hash mode) / hash_coin and round_tpu/engine/scenarios.py::link_bernoulli:
// every link drop is a murmur3 finalizer over (link index, round, scenario
// salts).  hw mode takes the place of the TPU's hardware PRNG
// (round_tpu/ops/fused.py::_keep_mask, hw branch) with Philox4x32-10 keyed
// by (salt0, salt1r); round_tpu_torch/ops/fused.py::philox4x32_10 is its
// plain twin.  Either way a kernel and the plain PyTorch versions agree bit
// for bit.
#pragma once

#include <stdint.h>

#define RT_GOLD 0x9E3779B9u  // per-link stride
#define RT_RMIX 0x7FEB352Du  // per-round stride
#define RT_COIN 0x1B873593u  // lane-coin stream separator

__device__ __forceinline__ uint32_t rt_fmix32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 13;
  z *= 0xC2B2AE35u;
  z ^= z >> 16;
  return z;
}

// Round-premixed salt: salt1r = r * RMIX + salt1 (uint32 wrap).
__device__ __forceinline__ uint32_t rt_salt1r(int r, int salt1) {
  return (uint32_t)r * RT_RMIX + (uint32_t)salt1;
}

// The 8-bit drop draw of link idx = j * n + i (receiver j, sender i):
// fmix32(idx * GOLD + salt0 ^ salt1r) & 0xFF.
__device__ __forceinline__ uint32_t rt_link_draw(uint32_t idx, uint32_t salt0,
                                                 uint32_t salt1r) {
  return rt_fmix32((idx * RT_GOLD + salt0) ^ salt1r) & 0xFFu;
}

// Link idx survives the iid drop: keep iff its draw >= p8.  p8 <= 0 keeps
// every link without hashing.  The diagonal is the caller's.
__device__ __forceinline__ bool rt_link_keep(uint32_t idx, uint32_t salt0,
                                             uint32_t salt1r, int p8) {
  if (p8 <= 0) return true;
  return rt_link_draw(idx, salt0, salt1r) >= (uint32_t)p8;
}

// Fair coin per (scenario, lane, round): round_tpu/ops/fused.py::hash_coin.
__device__ __forceinline__ bool rt_hash_coin(uint32_t salt0, uint32_t salt1,
                                             uint32_t r, uint32_t lane) {
  uint32_t z = lane * RT_GOLD + salt0;
  z ^= r * RT_RMIX + salt1 + RT_COIN;
  return (rt_fmix32(z) & 1u) == 1u;
}

// Philox4x32-10 (Salmon et al., SC'11, "Random123"): the four 32-bit words
// of counter c under key (k0, k1).  Each round is two 32x32 -> 64-bit
// products (mul.hi and mul.lo of one IMAD.WIDE) and two three-way xors.
#define RT_PHILOX_M0 0xD2511F53u
#define RT_PHILOX_M1 0xCD9E8D57u
#define RT_PHILOX_W0 0x9E3779B9u
#define RT_PHILOX_W1 0xBB67AE85u

__device__ __forceinline__ uint4 rt_philox4x32_10(uint4 c, uint32_t k0,
                                                  uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += RT_PHILOX_W0;
      k1 += RT_PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(RT_PHILOX_M0, c.x);
    const uint32_t lo0 = RT_PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(RT_PHILOX_M1, c.z);
    const uint32_t lo1 = RT_PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The hw-mode link stream of one (scenario, round), keyed (salt0, salt1r).
// Element e of the stream is word e & 3 of Philox(counter (e >> 2, 0, 0,
// 0)); link idx = j * n + i draws byte idx & 3 of element idx >> 2, so one
// Philox call (counter idx >> 4) covers 16 consecutive links.  The last
// call's four words stay in registers: a thread walking links in ascending
// order calls Philox once per 16 of them.
struct RtHwStream {
  uint32_t k0, k1;
  uint32_t ctr;  // counter of the cached words; never idx >> 4 at first
  uint4 w;

  __device__ __forceinline__ RtHwStream(uint32_t salt0, uint32_t salt1r)
      : k0(salt0), k1(salt1r), ctr(0xFFFFFFFFu), w(make_uint4(0, 0, 0, 0)) {}

  // The 8-bit draw of link idx.
  __device__ __forceinline__ uint32_t draw(uint32_t idx) {
    const uint32_t c = idx >> 4;
    if (c != ctr) {
      ctr = c;
      w = rt_philox4x32_10(make_uint4(c, 0u, 0u, 0u), k0, k1);
    }
    const uint32_t q = (idx >> 2) & 3u;
    const uint32_t word = q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w;
    return (word >> ((idx & 3u) * 8u)) & 0xFFu;
  }
};

// hw-mode keep threshold: link kept iff its draw >= min(p8, 255), for
// p8 > 0 (the caller keeps every link when p8 <= 0).  P(keep) = 1 - p8/256;
// p8 >= 256 senders are silenced by the caller, as in round_tpu.
__device__ __forceinline__ uint32_t rt_hw_threshold(int p8) {
  return p8 < 255 ? (uint32_t)p8 : 255u;
}
