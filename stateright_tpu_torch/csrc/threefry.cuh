// JAX's threefry random stream on the card (device functions, no kernel).
//
// The device form of stateright_tpu_torch/ops/prng.py, bit for bit with
// jax.random under JAX 0.9.0's defaults (threefry2x32, partitionable
// threefry, 32-bit mode): the 20-round Threefry-2x32 hash of
// jax/_src/prng.py:883, fold_in, the two-way split, 32 random bits and
// randint(key, (), 0, maxval) of jax/_src/random.py:581.  The walk kernel
// (walk.cu) includes it.
#pragma once

#include <cstdint>

namespace tf {

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32 of the counter (x0, x1) under key k; returns the two words.
__device__ __forceinline__ Key hash(Key k, uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k.k0, k.k1, k.k0 ^ k.k1 ^ 0x1BD11BDAu};
  constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return Key{x0, x1};
}

// jax.random.fold_in(key, data): the counter (0, data).
__device__ __forceinline__ Key fold_in(Key k, uint32_t data) {
  return hash(k, 0u, data);
}

// jax.random.split(key): row 0 becomes the new key, row 1 the subkey.
__device__ __forceinline__ void split(Key k, Key& key, Key& sub) {
  key = hash(k, 0u, 0u);
  sub = hash(k, 0u, 1u);
}

// 32 random bits of a key (the partitionable path's bits1 ^ bits2).
__device__ __forceinline__ uint32_t bits(Key k) {
  const Key y = hash(k, 0u, 0u);
  return y.k0 ^ y.k1;
}

// jax.random.randint(key, (), 0, maxval), dtype int32, for a uint32 maxval:
// two draws from the split key, then JAX's u32 modulus arithmetic.
__device__ __forceinline__ int32_t randint(Key k, uint32_t maxval) {
  const bool out_of_range = maxval > 0x7FFFFFFFu;
  uint32_t span = out_of_range ? 0x7FFFFFFFu : maxval;
  if (span == 0u) span = 1u;
  if (out_of_range) span += 1u;
  Key k_hi, k_lo;
  split(k, k_hi, k_lo);
  const uint32_t hi = bits(k_hi), lo = bits(k_lo);
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  const uint32_t off = ((hi % span) * mult + lo % span) % span;
  return static_cast<int32_t>(off);
}

}  // namespace tf
