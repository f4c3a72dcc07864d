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
//   K2  Merkle nodes: Keccak-256(left || right) of (2k, 4) digests, one
//       level or every level of a tree, in one launch.
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
// word).  K1 and K3 use no shared memory: nothing is reused between
// messages.
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
//
// K2 builds a whole Merkle tree in one launch (and one level, for the FRI
// chain's draw).  Its first blocks each take 512 leaves: 256 threads hash
// the 256 pairs from device memory, keep the parents in shared memory (8 KB)
// and hash the next level there, behind __syncthreads, writing both levels
// out.  A launch a level costs the host some 25 us a launch, and the card a
// launch gap and a permutation's latency (some 6 us for a lone warp) a
// level.  Resolving many levels in every block instead idles its upper
// levels' warps while they hold their registers: on the H100 a launch over
// 2^21 leaves took a tenth longer at 3 levels a block than a launch a
// level, a sixth longer at 4.  So a task resolves 2 levels (the second
// keeps half the warps busy, which cost nothing measurable), and of each 4
// tasks whose 4 x 128 nodes make the next task's 512 children, the block
// that finishes last (an atomic count behind __threadfence) goes on with
// that task, reading its children from L2; the others exit and free their
// SM.  The task over the last 512 or fewer children resolves all their
// levels, up to L = kTreeLevels = 9, to the root.  Bound: the n - 1
// permutations of a tree over n leaves.
#include <cuda_runtime.h>
#include <stdint.h>

#include "keccak.cuh"

namespace {

constexpr int kThreads = 128;   // a thread holds some 100 registers
// K2: threads a block, the children of a task (log2 of it: the levels a
// block resolves at most), the levels a task resolves below the top, and
// the tasks whose nodes make one task above them
constexpr int kTreeThreads = 256;
constexpr int kTreeChunk = 2 * kTreeThreads;
constexpr int kTreeLevels = 9;
constexpr int kTreeStep = 2;
constexpr int kTreeGroup = 4;
static_assert(kTreeChunk == 1 << kTreeLevels, "a block's subtree");
static_assert(kTreeGroup * (kTreeChunk >> kTreeStep) == kTreeChunk,
              "a group's nodes make a task");

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

// Node lv of the tree above n_in children (n_in a power of two, or lv = 1):
// level lv starts at node n_in - (n_in >> (lv - 1)) of `out`.
__device__ __forceinline__ long long level_start(long long n_in, int lv) {
  return n_in - (n_in >> (lv - 1));
}

// The tree above n_in child digests, `levels` levels of it (1, or all when
// n_in is a power of two), in one launch.  A task is a chunk of kTreeChunk
// children at level lv0 (the leaves: lv0 = 0): thread t of its block hashes
// children 2t and 2t + 1, and each further level's thread t nodes 2t and
// 2t + 1 of the level below, kept in shared memory behind __syncthreads.  A
// task resolves kTreeStep levels and writes them out; of each group of
// kTreeGroup tasks (their kTreeChunk nodes are the next task's children)
// the block that finishes last, told by an atomic count behind a fence,
// goes on with that task, reading its children from L2, while the others
// exit and free their SM for other chunks.  The task over the last
// kTreeChunk or fewer children resolves every level left, to the root.
__global__ void __launch_bounds__(kTreeThreads)
keccak_pairs_kernel(const u64* __restrict__ in, long long n_in, int levels,
                    u64* __restrict__ out, unsigned int* __restrict__ counts) {
  __shared__ u64 node[kTreeThreads][4];
  __shared__ int go_on;
  const int t = threadIdx.x;
  long long chunk = blockIdx.x, count = n_in, first_count = 0;
  int lv0 = 0;
#pragma unroll 1
  for (;;) {
    const long long base = chunk * kTreeChunk;
    const int width = count - base < kTreeChunk ? (int)(count - base) : kTreeChunk;
    const bool top = count <= kTreeChunk;
    int todo = top ? 31 - __clz(width) : kTreeStep;
    if (todo > levels - lv0) todo = levels - lv0;
    const u64* src = lv0 == 0 ? in : out + level_start(n_in, lv0) * 4;
#pragma unroll 1
    for (int lv = 1; lv <= todo; ++lv) {
      const bool active = t < (width >> lv);
      u64 s[25];
      if (active) {
        if (lv > 1) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i] = node[2 * t][i];
            s[4 + i] = node[2 * t + 1][i];
          }
        } else if (lv0 == 0) {
          const u64* p = src + (base + 2 * t) * 4;
#pragma unroll
          for (int i = 0; i < 8; ++i) s[i] = __ldg(p + i);
        } else {  // written by other blocks of this launch: from L2
          const u64* p = src + (base + 2 * t) * 4;
#pragma unroll
          for (int i = 0; i < 8; ++i) s[i] = __ldcg(p + i);
        }
#pragma unroll
        for (int i = 8; i < 25; ++i) s[i] = 0;
        s[8] = 0x01;  // a 64-byte message
        s[kRate - 1] = kPadLast;
        keccak_f(s);
      }
      if (lv > 1) __syncthreads();  // the level below is read before it is rewritten
      if (active) {
        u64* o = out + (level_start(n_in, lv0 + lv) + (base >> lv) + t) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[j] = s[j];
          node[t][j] = s[j];
        }
      }
      __syncthreads();
    }
    if (top || lv0 + todo == levels) return;
    // the group's count: its last block goes on
    const long long tasks = count / kTreeChunk;
    const long long group = tasks < kTreeGroup ? tasks : kTreeGroup;
    __threadfence();
    __syncthreads();
    if (t == 0) go_on = atomicAdd(counts + first_count + chunk / group, 1u) == group - 1;
    __syncthreads();
    if (!go_on) return;
    __threadfence();
    first_count += tasks / group;
    chunk /= group;
    lv0 += kTreeStep;
    count >>= kTreeStep;
  }
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

// (n_in, 4) digests -> the `levels` levels above them, (n_in/2 + ... +
// n_in/2^levels, 4), one after the other: levels 1 (n_in even), or all of
// them (n_in a power of two); `counts`: the zeros of the tasks' group
// counts (hash/cuda_keccak.py:tree_counts), unused for one level
int lcp_keccak_pairs(const void* digests, long long n_in, int levels, void* out,
                     void* counts, void* stream) {
  if (n_in < 0 || n_in / 2 > kMaxThreads || n_in % 2 || levels < 1 ||
      (levels > 1 && ((n_in & (n_in - 1)) || (1LL << levels) != n_in)))
    return (int)cudaErrorInvalidValue;
  if (n_in == 0) return 0;
  if (levels > 1 && n_in > kTreeChunk && counts == nullptr)
    return (int)cudaErrorInvalidValue;
  const unsigned int grid = (unsigned int)((n_in + kTreeChunk - 1) / kTreeChunk);
  keccak_pairs_kernel<<<grid, kTreeThreads, 0, (cudaStream_t)stream>>>(
      (const u64*)digests, n_in, levels, (u64*)out, (unsigned int*)counts);
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
