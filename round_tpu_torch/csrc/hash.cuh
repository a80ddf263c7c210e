// Shared device helpers of the hash-mode fault model.
//
// Bit-exact with round_tpu/ops/fused.py::_fmix32 / _keep_mask (hash mode) /
// hash_coin and round_tpu/engine/scenarios.py::link_bernoulli: every link
// drop is a murmur3 finalizer over (link index, round, scenario salts), so
// a kernel and the plain PyTorch versions agree bit for bit.
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
