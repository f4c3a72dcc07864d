// Stark252 field arithmetic for the port's CUDA kernels.
//
// p = 2^251 + 17*2^192 + 1.  Elements are in Montgomery form (R = 2^256) and
// canonical (< p).  In memory an operand is the JAX package's layout: 16
// little-endian 16-bit limbs on the leading axis, one int32 word per limb
// (values < 2^16), so limb k of element e sits at base[k * limb_stride + e].
// In registers an element is 8 little-endian 32-bit words.
//
// In 32-bit words p = [1, 0, 0, 0, 0, 0, 17, 2^27], and p = 1 (mod 2^32), so
// -p^-1 mod 2^32 = 0xFFFFFFFF and each CIOS reduction factor is m = -t0.
#pragma once

#include <stdint.h>

namespace lcp {

__device__ __forceinline__ uint32_t p_word(int k) {
  return k == 0 ? 1u : (k == 6 ? 17u : (k == 7 ? (1u << 27) : 0u));
}

__device__ __forceinline__ void load_elem(const int32_t* base, long long limb_stride,
                                          long long idx, uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t lo = (uint32_t)base[(2 * k) * limb_stride + idx];
    uint32_t hi = (uint32_t)base[(2 * k + 1) * limb_stride + idx];
    w[k] = (lo & 0xFFFFu) | (hi << 16);
  }
}

__device__ __forceinline__ void store_elem(int32_t* base, long long limb_stride,
                                           long long idx, const uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    base[(2 * k) * limb_stride + idx] = (int32_t)(w[k] & 0xFFFFu);
    base[(2 * k + 1) * limb_stride + idx] = (int32_t)(w[k] >> 16);
  }
}

// a <- a - p when a >= p (a < 2^256).
__device__ __forceinline__ void cond_sub_p(uint32_t a[8]) {
  uint32_t d[8];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint64_t t = (uint64_t)a[k] - (uint64_t)p_word(k) - (uint64_t)borrow;
    d[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  if (!borrow) {
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = d[k];
  }
}

// r = (a + b) mod p.  a + b < 2p < 2^253, so no carry leaves word 7.
__device__ __forceinline__ void add_mod(const uint32_t a[8], const uint32_t b[8],
                                        uint32_t r[8]) {
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint64_t s = (uint64_t)a[k] + (uint64_t)b[k] + c;
    r[k] = (uint32_t)s;
    c = s >> 32;
  }
  cond_sub_p(r);
}

// r = (a - b) mod p.
__device__ __forceinline__ void sub_mod(const uint32_t a[8], const uint32_t b[8],
                                        uint32_t r[8]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint64_t t = (uint64_t)a[k] - (uint64_t)b[k] - (uint64_t)borrow;
    r[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint64_t s = (uint64_t)r[k] + (uint64_t)p_word(k) + c;
      r[k] = (uint32_t)s;
      c = s >> 32;
    }
  }
}

// r = a * b * 2^-256 mod p (CIOS Montgomery product, 32-bit words).
__device__ __forceinline__ void mont_mul(const uint32_t a[8], const uint32_t b[8],
                                         uint32_t r[8]) {
  uint32_t t[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // t += a[i] * b
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)t[j] + (uint64_t)a[i] * (uint64_t)b[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    // t += m * p with m = -t[0] mod 2^32; the low word becomes 0
    uint32_t m = 0u - t[0];
    s = (uint64_t)t[0] + (uint64_t)m;
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 6; ++j) {
      s = (uint64_t)t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[6] + (uint64_t)m * 17u + c;
    t[6] = (uint32_t)s;
    c = s >> 32;
    s = (uint64_t)t[7] + ((uint64_t)m << 27) + c;
    t[7] = (uint32_t)s;
    c = s >> 32;
    s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] += (uint32_t)(s >> 32);
    // divide by 2^32
#pragma unroll
    for (int j = 0; j < 9; ++j) t[j] = t[j + 1];
    t[9] = 0;
  }
  // t < 2p < 2^253: words 8 and 9 are zero
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = t[k];
  cond_sub_p(r);
}

}  // namespace lcp
