// Keccak-f[1600] for the port's kernels (keccak.cu: K1-K3; fri_tail.cu:
// K4): one thread a message, the 25 lanes of the state in registers, every
// round unrolled so that each lane index and rotation amount is a constant,
// 64-bit rotations as two funnel shifts, chi as a ^ (~b & c).
#pragma once

#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kRate = 17;       // lanes of a 136-byte block
constexpr u64 kPadLast = 0x8000000000000000ULL;  // 0x80 in the block's last byte

__constant__ u64 kRoundConstants[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

// rotate left by r, a constant once the caller is unrolled
__device__ __forceinline__ u64 rotl(u64 x, int r) {
  const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  uint32_t nlo, nhi;
  if (r == 0) {
    return x;
  } else if (r < 32) {
    nhi = __funnelshift_l(lo, hi, r);
    nlo = __funnelshift_l(hi, lo, r);
  } else if (r == 32) {
    nhi = lo;
    nlo = hi;
  } else {
    nhi = __funnelshift_l(hi, lo, r - 32);
    nlo = __funnelshift_l(lo, hi, r - 32);
  }
  return ((u64)nhi << 32) | nlo;
}

// keccak-f[1600] on a[x + 5y]
__device__ __forceinline__ void keccak_f(u64 (&a)[25]) {
  // rho amount of lane x + 5y
  const int rho[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                       25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
#pragma unroll
  for (int round = 0; round < 24; ++round) {
    u64 c[5], d[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) d[x] = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
    // theta, rho and pi: b[y + 5((2x + 3y) % 5)] = rotl(a[x + 5y] ^ d[x], rho)
#pragma unroll
    for (int i = 0; i < 25; ++i) {
      const int x = i % 5, y = i / 5;
      b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(a[i] ^ d[x], rho[i]);
    }
    // chi
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
#pragma unroll
      for (int x = 0; x < 5; ++x) {
        a[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
      }
    }
    a[0] ^= kRoundConstants[round];
  }
}

}  // namespace
