// K1 `keccak_rows`, K2 `keccak_pairs` and K3 `keccak_grind`: Keccak-256 on
// the card.
//
// They replace no Pallas kernel: the JAX package computes Keccak in jnp
// under jax.jit (hash/keccak_device.py: _keccak_f and _absorb_words, under
// hash_felt_rows, hash_digest_pairs and grinding_batch), and the port ran
// the same whole-state ops eagerly, some 22 PyTorch launches a round.
//
//   K1  row leaves: Keccak-256 of the 32-byte big-endian encodings of a
//       row's c felts, read from (16, c, n) int32 canonical limbs with any
//       strides, one digest (4 int64 lanes) a row.
//   K2  Merkle parents: Keccak-256(left || right) of (2k, 4) digests.
//   K3  grinding: Keccak-256(challenge || nonce_le_u64) for the nonces
//       start .. start + size - 1; the first index whose lane 0 passes the
//       mask test is written into *first by atomicMin (the caller sets it
//       to size first).
//
// Bound on the H100: integer instructions.  A permutation is some 190
// 32-bit instructions a round (a 64-bit XOR, AND-NOT or rotate is two
// LOP3 or SHF), 24 rounds; a row of 34 felts reads 2,176 B and takes 9
// permutations, so operations outweigh bytes some 4 to 1.  The design:
// one thread a message, the 25 lanes of the state in registers, every
// round unrolled so that each lane index and rotation amount is a constant,
// 64-bit rotations as two funnel shifts, chi as a ^ (~b & c) (one LOP3 a
// word).  No shared memory: nothing is reused between messages.
//
// K1's message is never formed in memory.  Lane k (0..3) of a felt's
// encoding holds BE bytes 8k .. 8k+7, i.e. limbs 15-4k .. 12-4k each with
// its two bytes swapped, limb 15-4k lowest; the felt of column j fills
// message lanes 4j .. 4j+3.  A block of 17 lanes is built where it is
// absorbed: lane i of block b is message lane 17b + i (a register index
// known at compile time, a limb address computed at run time), then the
// padding: 0x01 in the lane after the message, 0x80 in the top byte of the
// last block's lane 16 (a message of 17 felts or 34 ends on a block and the
// padding fills a block of its own).  Consecutive threads take consecutive
// rows, so with a unit row stride every limb load of a warp is one run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kRate = 17;       // lanes of a 136-byte block
constexpr int kThreads = 128;   // a thread holds some 100 registers
constexpr u64 kPadLast = 0x8000000000000000ULL;

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

// message lane k of the felt whose limb 0 is at p: limbs 15-4k .. 12-4k,
// each byte-swapped, the first in the low 16 bits
__device__ __forceinline__ u64 felt_lane(const int32_t* __restrict__ p, long long ls, int k) {
  const int top = 15 - 4 * k;
  const uint32_t l0 = (uint32_t)__ldg(p + (long long)top * ls);
  const uint32_t l1 = (uint32_t)__ldg(p + (long long)(top - 1) * ls);
  const uint32_t l2 = (uint32_t)__ldg(p + (long long)(top - 2) * ls);
  const uint32_t l3 = (uint32_t)__ldg(p + (long long)(top - 3) * ls);
  // bytes 1, 0 of the first limb, then bytes 1, 0 of the second
  return ((u64)__byte_perm(l2, l3, 0x4501) << 32) | __byte_perm(l0, l1, 0x4501);
}

__global__ void __launch_bounds__(kThreads)
keccak_rows_kernel(const int32_t* __restrict__ limbs, long long ls, long long cs,
                   long long rs, int n_cols, long long n_rows, u64* __restrict__ out) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= n_rows) return;
  const int32_t* base = limbs + row * rs;
  const int n_lanes = 4 * n_cols;
  const int n_blocks = n_lanes / kRate + 1;
  u64 s[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) s[i] = 0;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int m0 = blk * kRate;
#pragma unroll
    for (int i = 0; i < kRate; ++i) {
      const int m = m0 + i;
      u64 v = 0;
      if (m < n_lanes) v = felt_lane(base + (long long)(m >> 2) * cs, ls, m & 3);
      if (m == n_lanes) v ^= 0x01;
      if (i == kRate - 1 && blk == n_blocks - 1) v ^= kPadLast;
      s[i] ^= v;
    }
    keccak_f(s);
  }
  u64* o = out + row * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = s[j];
}

__global__ void __launch_bounds__(kThreads)
keccak_pairs_kernel(const u64* __restrict__ in, long long k, u64* __restrict__ out) {
  const long long node = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (node >= k) return;
  const u64* p = in + node * 8;
  u64 s[25];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = __ldg(p + i);
#pragma unroll
  for (int i = 8; i < 25; ++i) s[i] = 0;
  s[8] = 0x01;  // a 64-byte message
  s[kRate - 1] = kPadLast;
  keccak_f(s);
  u64* o = out + node * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = s[j];
}

__global__ void __launch_bounds__(kThreads)
keccak_grind_kernel(u64 c0, u64 c1, u64 c2, u64 c3, u64 start, long long size,
                    u64 mask, unsigned long long* __restrict__ first) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= size) return;
  u64 s[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) s[i] = 0;
  s[0] = c0;
  s[1] = c1;
  s[2] = c2;
  s[3] = c3;
  s[4] = start + (u64)idx;
  s[5] = 0x01;  // a 40-byte message
  s[kRate - 1] = kPadLast;
  keccak_f(s);
  if ((s[0] & mask) == 0) atomicMin(first, (unsigned long long)idx);
}

unsigned int grid_for(long long n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

constexpr long long kMaxThreads = (long long)kThreads * 0x7FFFFFFF;

}  // namespace

extern "C" {

// (16, n_cols, n_rows) int32 limbs with strides ls, cs, rs (elements) ->
// (n_rows, 4) digests
int lcp_keccak_rows(const void* limbs, long long ls, long long cs, long long rs,
                    int n_cols, long long n_rows, void* out, void* stream) {
  if (n_cols < 0 || n_cols > (1 << 24) || n_rows < 0 || n_rows > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  keccak_rows_kernel<<<grid_for(n_rows), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)limbs, ls, cs, rs, n_cols, n_rows, (u64*)out);
  return (int)cudaGetLastError();
}

// (2k, 4) digests -> (k, 4) parents
int lcp_keccak_pairs(const void* digests, long long k, void* out, void* stream) {
  if (k < 0 || k > kMaxThreads) return (int)cudaErrorInvalidValue;
  if (k == 0) return 0;
  keccak_pairs_kernel<<<grid_for(k), kThreads, 0, (cudaStream_t)stream>>>(
      (const u64*)digests, k, (u64*)out);
  return (int)cudaGetLastError();
}

// the nonces start .. start + size - 1 against lane-0 mask; *first (a u64 the
// caller set to size) becomes the smallest passing index
int lcp_keccak_grind(unsigned long long c0, unsigned long long c1, unsigned long long c2,
                     unsigned long long c3, unsigned long long start, long long size,
                     unsigned long long mask, void* first, void* stream) {
  if (size < 0 || size > kMaxThreads) return (int)cudaErrorInvalidValue;
  if (size == 0) return 0;
  keccak_grind_kernel<<<grid_for(size), kThreads, 0, (cudaStream_t)stream>>>(
      c0, c1, c2, c3, start, size, mask, (unsigned long long*)first);
  return (int)cudaGetLastError();
}

}  // extern "C"
