// H5 `mont_batch_inverse` and H6 `mont_prefix_product`: the scans over the
// Montgomery product, on (16, n) int32 canonical Montgomery limbs.
//
// They replace the JAX package's field/device.py:batch_inverse (:405: the
// forward lax.scan :434 and the backward lax.scan :448 over _mul_kernel, and
// the Fermat inv of the chunk totals, a lax.scan over the exponent's bits,
// :386) and prefix_product (:458: the lax.scan :484, the associative_scan of
// the block totals :486 and the offset product).  On the TPU each of them is
// one compiled device loop whose body is the Pallas product
// (field/pallas_mul.py:_mul_kernel); a scan step launched from the host costs
// a launch for well under a microsecond of work.
//
// Bound on the H100: bytes.  Each element is read once and written once,
// 128 B in the limb layout, at 3.35 TB/s; the Montgomery trick needs 3
// products an element and a prefix product 1, at 80 integer instructions
// each, which stays below the bytes' time.  The totals add 64 B a tile.
//
// What the design does about it: the running product of a scan stays in a
// thread's registers (8 words, as lax.scan keeps its carry), and every
// element is read coalesced.
//
// H5, three launches, and no running product ever goes to device memory:
// 192 B an element by design (x read twice, the inverses written once)
// where the bound counts 128, plus 64 B a tile for the totals.  Any
// partition gives the same inverses; a tile is kInvTile = 512 contiguous
// elements, a thread's run kRun = 4 of them (16-byte loads of each limb row
// where n % 4 == 0).  (1) inv_reduce: each tile's product, zeros taken as
// one; (2) inv_totals inverts the k tile totals in place: a block takes
// kMidThreads * q of them, each thread q, a product tree of the block's
// kMidThreads partial products in shared memory, the root's inverse by two
// chains in two warps (inv_low, inv_high: 253 dependent products where one
// Fermat chain took 444) and the tree back down; (3) inv_apply reads its
// tile again and forms each element's inverse from the tile's inverse and
// prefix and suffix products of its runs (registers, shuffles, and 512 B of
// shared memory for the warps' totals).  What holds it under the bytes'
// time, as far as the H100 runs show, is the products: 7.5 an element (2 in
// the reduce, 5.5 in the apply; the trick's least is 3), some 130 IMAD each
// in the SASS, at most two warp-wide IMAD a cycle an SM.  Runs of 8 in
// shared memory (5.6 products an element) ran slower on the H100, as did
// persistent blocks that staged the next tile by cp.async.  Zeros map to
// zero, as in lambdaworks' inplace_batch_inverse.
//
// H6, one launch (and a memset of its status words), a single pass with
// decoupled look-back: x is read once and out written once, 128 B an
// element, plus 4 B of flag and 64 B of payload a tile.  A block takes a
// tile of kTile contiguous elements, its index from an atomic counter (so a
// block only ever waits on tiles that running blocks hold); thread t a run
// of kPerThread consecutive elements, read as H5's runs are.  (1) The run's
// inclusive products (3), which wait in shared memory, not in registers,
// so that kTileBlocks blocks fit an SM; a warp scan of the runs' totals by
// shuffles (5); warp 0 scans the warps' totals (2): the tile's aggregate,
// which it publishes at once.  (2) Warp 0 looks back over the tiles
// before, 32 at a time (lane i at tile b - i): when none of them is still
// unpublished, the lanes up to the nearest inclusive prefix (or all 32,
// and the walk goes on 32 further back) multiply their payloads into
// their own products; at the inclusive prefix the lanes' products are
// multiplied together, and the tile publishes its inclusive prefix.  (3)
// Each thread's offset is (the tile's exclusive prefix times its warp's)
// times its lane's (1), times each inclusive product of its run (4): 3.25
// products an element, against 5.5 for the three passes it replaced.
// Readiness is the flag alone (a zero tile has a zero aggregate): a
// payload is written (L2, st.cg), then __threadfence, then its flag by
// st.release.gpu; a reader takes the flag by ld.acquire.gpu and the
// payload through L2 (ld.cg).  The launcher zeroes the counter and the
// flags on the caller's stream before every launch.  A single tile
// launches alone, with no status words.  The variants measured against
// this design, and what holds it under its bound: PERF.md section 6.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

namespace {

constexpr int kInvThreads = 128;   // H5's tile passes: threads a block
constexpr int kRun = 4;            // H5: consecutive elements a thread
constexpr int kInvTile = kInvThreads * kRun;
constexpr int kInvWarps = kInvThreads / 32;
constexpr int kMidThreads = 256;   // H5's totals: leaves of a block's tree
// the root's inverse: p - 2 = 2^kLowBits (2^(kHighShift + kHighTail) +
// 2^kHighTail) + (2^kLowBits - 1), two chains in two warps
constexpr int kLowBits = 192;
constexpr int kHighShift = 55;
constexpr int kHighTail = 4;
constexpr int kTileThreads = 128;  // H6: threads a tile
constexpr int kPerThread = 4;      // H6: consecutive elements a thread scans
constexpr int kTile = kTileThreads * kPerThread;
constexpr int kWarps = kTileThreads / 32;
constexpr int kTileBlocks = 6;     // H6: blocks an SM (registers <= 85)
// H6's status words: the tile counter, padded to 32 B; one flag a tile,
// padded to 32 B; then a slot of 16 words a tile, its aggregate and its
// inclusive prefix
constexpr int kStatusHead = 8;
constexpr int kSlotWords = 16;
constexpr unsigned kNone = 0, kAggregate = 1, kInclusive = 2;  // a tile's flag
constexpr unsigned kFull = 0xFFFFFFFFu;

// R mod p, the Montgomery form of one
__device__ __forceinline__ void set_one(uint32_t w[8]) {
  w[0] = 0xFFFFFFE1u;
  w[1] = 0xFFFFFFFFu;
  w[2] = 0xFFFFFFFFu;
  w[3] = 0xFFFFFFFFu;
  w[4] = 0xFFFFFFFFu;
  w[5] = 0xFFFFFFFFu;
  w[6] = 0xFFFFFDF0u;
  w[7] = 0x07FFFFFFu;
}

__device__ __forceinline__ bool is_zero(const uint32_t w[8]) {
  uint32_t any = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) any |= w[k];
  return any == 0;
}

__device__ __forceinline__ void copy8(uint32_t d[8], const uint32_t s[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) d[k] = s[k];
}

// Inclusive product scan over lanes 0 .. kWidth - 1 of a warp.
template <int kWidth>
__device__ __forceinline__ void warp_scan(uint32_t acc[8]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < kWidth; off *= 2) {
    uint32_t y[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) y[w] = __shfl_up_sync(kFull, acc[w], off);
    if (lane >= off) lcp::mont_mul(y, acc, acc);
  }
}

// The lane before's value, one on lane 0.
__device__ __forceinline__ void lane_before(const uint32_t incl[8], uint32_t ex[8]) {
#pragma unroll
  for (int w = 0; w < 8; ++w) ex[w] = __shfl_up_sync(kFull, incl[w], 1);
  if ((threadIdx.x & 31) == 0) set_one(ex);
}

// a <- a^(2^k): k squarings
__device__ __forceinline__ void sqr_n(uint32_t a[8], int k) {
#pragma unroll 1
  for (; k > 0; --k) lcp::mont_mul(a, a, a);
}

// The root's inverse a^(p - 2) is lo * hi, two independent chains:
// lo = a^(2^192 - 1) by a_2k = a_k^(2^k) a_k from a_1 = a, a_k = a^(2^k - 1)
// (k = 1, 2, 3, 6, ..., 192: 191 squarings, 8 products), and
// hi = a^(2^192 (2^59 + 2^4)) = ((a^(2^55) a)^(2^4))^(2^192) (251 squarings,
// 1 product).  One thread a chain: 253 dependent products, where the binary
// method's single chain took 444.
__device__ __forceinline__ void inv_low(const uint32_t a[8], uint32_t lo[8]) {
  uint32_t t[8];
  copy8(lo, a);
#pragma unroll 1
  for (int k = 1; k < 3; ++k) {  // a_2, a_3
    copy8(t, lo);
    sqr_n(t, 1);
    lcp::mont_mul(t, a, lo);
  }
#pragma unroll 1
  for (int k = 3; k < kLowBits; k *= 2) {
    copy8(t, lo);
    sqr_n(t, k);
    lcp::mont_mul(t, lo, lo);
  }
}

__device__ __forceinline__ void inv_high(const uint32_t a[8], uint32_t hi[8]) {
  copy8(hi, a);
  sqr_n(hi, kHighShift);
  lcp::mont_mul(hi, a, hi);
  sqr_n(hi, kHighTail + kLowBits);
}

// ---------------------------------------------------------------------------
// H5
// ---------------------------------------------------------------------------

// A thread's run: the kRun elements e0 .. e0 + kRun - 1, one past n taken
// as one.  kVec (n % kRun == 0, x and out 16-byte aligned): a run lies wholly
// below n or wholly past it, and each limb row of it is one 16-byte load or
// store, so a warp moves 512 contiguous bytes a row.
template <bool kVec>
__device__ __forceinline__ void load_run(const int32_t* __restrict__ x, long long n,
                                         long long e0, uint32_t v[kRun][8]) {
  if (kVec && e0 < n) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int4 lo = __ldg(reinterpret_cast<const int4*>(x + (2 * k) * n + e0));
      const int4 hi = __ldg(reinterpret_cast<const int4*>(x + (2 * k + 1) * n + e0));
      v[0][k] = ((uint32_t)lo.x & 0xFFFFu) | ((uint32_t)hi.x << 16);
      v[1][k] = ((uint32_t)lo.y & 0xFFFFu) | ((uint32_t)hi.y << 16);
      v[2][k] = ((uint32_t)lo.z & 0xFFFFu) | ((uint32_t)hi.z << 16);
      v[3][k] = ((uint32_t)lo.w & 0xFFFFu) | ((uint32_t)hi.w << 16);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    if (!kVec && e0 + r < n) {
      lcp::load_elem(x, n, e0 + r, v[r]);
    } else {
      set_one(v[r]);
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store_run(int32_t* __restrict__ out, long long n,
                                          long long e0, uint32_t v[kRun][8]) {
  if (kVec) {
    if (e0 >= n) return;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int4 lo = make_int4((int)(v[0][k] & 0xFFFFu), (int)(v[1][k] & 0xFFFFu),
                                (int)(v[2][k] & 0xFFFFu), (int)(v[3][k] & 0xFFFFu));
      const int4 hi = make_int4((int)(v[0][k] >> 16), (int)(v[1][k] >> 16),
                                (int)(v[2][k] >> 16), (int)(v[3][k] >> 16));
      *reinterpret_cast<int4*>(out + (2 * k) * n + e0) = lo;
      *reinterpret_cast<int4*>(out + (2 * k + 1) * n + e0) = hi;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    if (e0 + r < n) lcp::store_elem(out, n, e0 + r, v[r]);
  }
}

// The run's elements with zeros taken as one; bit r of the result is set
// where element r was zero.
__device__ __forceinline__ unsigned zeros_as_one(uint32_t v[kRun][8]) {
  unsigned z = 0;
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    if (is_zero(v[r])) {
      set_one(v[r]);
      z |= 1u << r;
    }
  }
  return z;
}

// (1) tot[b] = the product of tile b's elements, zeros taken as one.
template <bool kVec>
__global__ void __launch_bounds__(kInvThreads)
    inv_reduce_kernel(const int32_t* __restrict__ x, long long n,
                      int32_t* __restrict__ tot, long long nb) {
  __shared__ uint32_t wsum[8][kInvWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t v[kRun][8], acc[8];
  load_run<kVec>(x, n, (long long)blockIdx.x * kInvTile + tid * kRun, v);
  zeros_as_one(v);
  lcp::mont_mul(v[0], v[1], acc);
#pragma unroll
  for (int r = 2; r < kRun; ++r) lcp::mont_mul(acc, v[r], acc);
#pragma unroll
  for (int off = 16; off >= 1; off /= 2) {
    uint32_t y[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) y[w] = __shfl_xor_sync(kFull, acc[w], off);
    lcp::mont_mul(acc, y, acc);
  }
  if (lane == 0) {
#pragma unroll
    for (int w = 0; w < 8; ++w) wsum[w][warp] = acc[w];
  }
  __syncthreads();
  if (tid == 0) {
    for (int u = 1; u < kInvWarps; ++u) {
      uint32_t y[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) y[w] = wsum[w][u];
      lcp::mont_mul(acc, y, acc);
    }
    lcp::store_elem(tot, nb, blockIdx.x, acc);
  }
}

// Word-major tree node access: node[w][i].
__device__ __forceinline__ void node_get(uint32_t (*node)[2 * kMidThreads], int i,
                                         uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = node[k][i];
}

__device__ __forceinline__ void node_put(uint32_t (*node)[2 * kMidThreads], int i,
                                         const uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) node[k][i] = w[k];
}

// tot[e] <- tot[e]^-1 for e < k (all nonzero).  Block b takes the totals
// b kMidThreads q + i + t kMidThreads (t < q) to thread i; `pre` holds the
// thread's running products meanwhile.
__global__ void __launch_bounds__(kMidThreads)
    inv_totals_kernel(int32_t* __restrict__ tot, int32_t* __restrict__ pre, long long k,
                      long long q) {
  __shared__ uint32_t node[8][2 * kMidThreads];
  const int i = threadIdx.x;
  const long long e0 = (long long)blockIdx.x * kMidThreads * q + i;
  long long cnt = 0;
  if (e0 < k) {
    cnt = (k - 1 - e0) / kMidThreads + 1;
    if (cnt > q) cnt = q;
  }
  uint32_t acc[8], v[8], l[8], r[8];
  set_one(acc);
  for (long long t = 0; t < cnt; ++t) {
    lcp::load_elem(tot, k, e0 + t * kMidThreads, v);
    lcp::mont_mul(acc, v, acc);
    lcp::store_elem(pre, k, e0 + t * kMidThreads, acc);
  }
  // the tree: leaf kMidThreads + i is thread i's product, node m the
  // product of nodes 2m and 2m + 1, the root node 1
  node_put(node, kMidThreads + i, acc);
  __syncthreads();
  for (int half = kMidThreads / 2; half >= 1; half /= 2) {
    if (i < half) {
      node_get(node, 2 * (half + i), l);
      node_get(node, 2 * (half + i) + 1, r);
      lcp::mont_mul(l, r, v);
      node_put(node, half + i, v);
    }
    __syncthreads();
  }
  // the root's inverse: lo in thread 0 (warp 0), hi in thread 32 (warp 1)
  if (i == 0 || i == 32) {
    node_get(node, 1, v);
    if (i == 0) {
      inv_low(v, l);
    } else {
      inv_high(v, r);
      node_put(node, 0, r);  // node 0 is no node of the tree
    }
  }
  __syncthreads();
  if (i == 0) {
    node_get(node, 0, r);
    lcp::mont_mul(l, r, v);
    node_put(node, 1, v);
  }
  __syncthreads();
  // back down: the inverse of a child is the parent's inverse times its
  // sibling
  for (int half = 1; half < kMidThreads; half *= 2) {
    if (i < half) {
      const int m = half + i;
      node_get(node, m, v);
      node_get(node, 2 * m, l);
      node_get(node, 2 * m + 1, r);
      lcp::mont_mul(v, r, r);
      lcp::mont_mul(v, l, l);
      node_put(node, 2 * m, r);
      node_put(node, 2 * m + 1, l);
    }
    __syncthreads();
  }
  node_get(node, kMidThreads + i, acc);  // the inverse of the thread's product
  for (long long t = cnt - 1; t >= 0; --t) {
    const long long e = e0 + t * kMidThreads;
    if (t > 0) {
      lcp::load_elem(pre, k, e - kMidThreads, l);
      lcp::load_elem(tot, k, e, v);
      lcp::mont_mul(acc, l, r);
      lcp::mont_mul(acc, v, acc);
      lcp::store_elem(tot, k, e, r);
    } else {
      lcp::store_elem(tot, k, e, acc);
    }
  }
}

// (3) out = the inverses of tile b's elements (0 for a zero), from tinv[b],
// the inverse of the tile's product.  Thread t's run has the prefix products
// p_0 .. p_3 and total u = p_3; u^-1 is tinv times the products of the
// other runs of the tile: those before and after t in its warp (a prefix
// and a suffix scan by shuffles) and those of the warps before and after
// (warp 0 scans the warps' totals and multiplies in tinv).  The run then
// goes backwards as the Montgomery trick does: x_r^-1 = c p_(r-1) and c <-
// c x_r, from c = u^-1.
template <bool kVec>
__global__ void __launch_bounds__(kInvThreads)
    inv_apply_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n,
                     const int32_t* __restrict__ tinv, long long nb) {
  __shared__ uint32_t wsum[8][kInvWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long e0 = (long long)blockIdx.x * kInvTile + tid * kRun;
  uint32_t v[kRun][8], p[kRun - 1][8], pre[8], suf[8], y[8];
  load_run<kVec>(x, n, e0, v);
  const unsigned z = zeros_as_one(v);
  copy8(p[0], v[0]);
#pragma unroll
  for (int r = 1; r < kRun - 1; ++r) lcp::mont_mul(p[r - 1], v[r], p[r]);
  lcp::mont_mul(p[kRun - 2], v[kRun - 1], pre);
  copy8(suf, pre);
  // inclusive prefix (pre) and suffix (suf) products of the warp's runs
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    uint32_t d[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      y[w] = __shfl_up_sync(kFull, pre[w], off);
      d[w] = __shfl_down_sync(kFull, suf[w], off);
    }
    if (lane >= off) lcp::mont_mul(y, pre, pre);
    if (lane + off < 32) lcp::mont_mul(suf, d, suf);
  }
  if (lane == 31) {
#pragma unroll
    for (int w = 0; w < 8; ++w) wsum[w][warp] = pre[w];
  }
  // exclusive: the runs before and after this one in the warp
  lane_before(pre, pre);
#pragma unroll
  for (int w = 0; w < 8; ++w) y[w] = __shfl_down_sync(kFull, suf[w], 1);
  if (lane == 31) {
    set_one(suf);
  } else {
    copy8(suf, y);
  }
  lcp::mont_mul(pre, suf, pre);
  __syncthreads();
  if (warp == 0) {  // each warp's tinv * (the warps before) * (the warps after)
    uint32_t a[8], b[8], t[8];
    if (lane < kInvWarps) {
#pragma unroll
      for (int w = 0; w < 8; ++w) a[w] = wsum[w][lane];
    } else {
      set_one(a);
    }
    copy8(b, a);
#pragma unroll
    for (int off = 1; off < kInvWarps; off *= 2) {
      uint32_t d[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        t[w] = __shfl_up_sync(kFull, a[w], off);
        d[w] = __shfl_down_sync(kFull, b[w], off);
      }
      if (lane >= off) lcp::mont_mul(t, a, a);
      if (lane + off < kInvWarps) lcp::mont_mul(b, d, b);
    }
    lane_before(a, a);
#pragma unroll
    for (int w = 0; w < 8; ++w) t[w] = __shfl_down_sync(kFull, b[w], 1);
    if (lane >= kInvWarps - 1) set_one(t);
    lcp::load_elem(tinv, nb, blockIdx.x, b);
    lcp::mont_mul(a, t, a);
    lcp::mont_mul(a, b, a);
    __syncwarp();
    if (lane < kInvWarps) {
#pragma unroll
      for (int w = 0; w < 8; ++w) wsum[w][lane] = a[w];
    }
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < 8; ++w) y[w] = wsum[w][warp];
  lcp::mont_mul(pre, y, pre);  // u^-1
#pragma unroll
  for (int r = kRun - 1; r >= 1; --r) {
    uint32_t inv[8];
    lcp::mont_mul(pre, p[r - 1], inv);
    lcp::mont_mul(pre, v[r], pre);
    copy8(v[r], inv);
  }
  copy8(v[0], pre);
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    if (z & (1u << r)) {
#pragma unroll
      for (int w = 0; w < 8; ++w) v[r][w] = 0;
    }
  }
  store_run<kVec>(out, n, e0, v);
}

// ---------------------------------------------------------------------------
// H6
// ---------------------------------------------------------------------------

// H6's status words: where tile t's flag and slot lie
__host__ __device__ __forceinline__ long long flag_words(long long nb) {
  return kStatusHead + (nb + 7) / 8 * 8;
}

__device__ __forceinline__ unsigned ld_acquire(const int32_t* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Tile t's aggregate or inclusive prefix, then its flag; by one thread.
__device__ __forceinline__ void publish(int32_t* status, long long nb, long long t,
                                        unsigned kind, const uint32_t v[8]) {
  uint4* slot = reinterpret_cast<uint4*>(status + flag_words(nb) + kSlotWords * t +
                                         (kind == kInclusive ? 8 : 0));
  __stcg(slot, make_uint4(v[0], v[1], v[2], v[3]));
  __stcg(slot + 1, make_uint4(v[4], v[5], v[6], v[7]));
  __threadfence();
  asm volatile("st.release.gpu.u32 [%0], %1;"
               :
               : "l"(status + kStatusHead + t), "r"(kind)
               : "memory");
}

// pre = the product of tiles 0 .. t - 1 (t >= 1), on every lane of the
// calling warp: lane i looks at tile b - i of the windows b = t - 1, t - 33,
// ...  Once no tile of the window is unpublished, the lanes up to the
// nearest inclusive prefix (all 32 where there is none) multiply their
// payloads into their own running products, and the walk stops at an
// inclusive prefix; then the lanes' products are multiplied by xor
// shuffles (one dependent product a window, not five).  Tile 0 publishes
// its inclusive prefix before any look-back, so lanes past it never count.
__device__ __forceinline__ void look_back(const int32_t* status, long long nb, long long t,
                                          uint32_t pre[8]) {
  const int lane = threadIdx.x & 31;
  const int32_t* flags = status + kStatusHead;
  const int32_t* slots = status + flag_words(nb);
  set_one(pre);
  int top = 0;  // the highest lane with a payload
  for (long long b = t - 1;; b -= 32) {
    const long long j = b - lane;
    unsigned f;
    do {
      f = j >= 0 ? ld_acquire(flags + j) : kInclusive;
    } while (__any_sync(kFull, f == kNone));
    const unsigned incl = __ballot_sync(kFull, f == kInclusive);
    const int last = incl ? __ffs(incl) - 1 : 31;  // lanes 0 .. last count
    if (lane <= last && j >= 0) {
      const uint4* p = reinterpret_cast<const uint4*>(slots + kSlotWords * j +
                                                      (f == kInclusive ? 8 : 0));
      const uint4 lo = __ldcg(p), hi = __ldcg(p + 1);
      const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      lcp::mont_mul(pre, v, pre);
    }
    top = last > top ? last : top;
    if (incl) break;
  }
  for (int off = 1; off <= top; off *= 2) {  // lanes 0 .. 2 off - 1 on each
    uint32_t y[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) y[w] = __shfl_xor_sync(kFull, pre[w], off);
    lcp::mont_mul(pre, y, pre);
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) pre[w] = __shfl_sync(kFull, pre[w], 0);
}

// out = the inclusive prefix products of x, a tile of kTile elements a
// block.  status (null: a single tile, n <= kTile): the tile counter, the
// flags (zeroed before the launch) and the slots.
template <bool kVec>
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
    prefix_product_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                          long long n, int32_t* status, long long nb) {
  static_assert(kPerThread % kRun == 0, "a run is read kRun elements at a time");
  __shared__ uint32_t wsum[8][kWarps];
  // the runs' inclusive products, word-major and thread-minor (no bank
  // conflicts): they wait here, not in registers, through the look-back
  __shared__ uint32_t runs[kPerThread][8][kTileThreads];
  __shared__ unsigned tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long t = 0;
  if (status != nullptr) {
    if (tid == 0) tile = atomicAdd(reinterpret_cast<unsigned*>(status), 1u);
    __syncthreads();
    t = tile;
  }
  const long long e0 = t * kTile + tid * kPerThread;
  uint32_t ex[8];
#pragma unroll
  for (int q = 0; q < kPerThread; q += kRun) {
    uint32_t v[kRun][8];
    load_run<kVec>(x, n, e0 + q, v);
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      if (q + r == 0) {
        copy8(ex, v[0]);
      } else {
        lcp::mont_mul(ex, v[r], ex);
      }
#pragma unroll
      for (int w = 0; w < 8; ++w) runs[q + r][w][tid] = ex[w];
    }
  }
  warp_scan<32>(ex);
  if (lane == 31) {
#pragma unroll
    for (int w = 0; w < 8; ++w) wsum[w][warp] = ex[w];
  }
  lane_before(ex, ex);
  __syncthreads();
  if (warp == 0) {  // the warps' offsets, times the tiles' before
    uint32_t s[8], o[8], pre[8];
    if (lane < kWarps) {
#pragma unroll
      for (int w = 0; w < 8; ++w) s[w] = wsum[w][lane];
    } else {
      set_one(s);
    }
    warp_scan<kWarps>(s);  // lane kWarps - 1: the tile's aggregate
    lane_before(s, o);
    if (status != nullptr) {
      if (t == 0) {
        if (lane == kWarps - 1) publish(status, nb, 0, kInclusive, s);
      } else {
        if (lane == kWarps - 1) publish(status, nb, t, kAggregate, s);
        look_back(status, nb, t, pre);
        if (lane == kWarps - 1) {
          lcp::mont_mul(pre, s, s);
          publish(status, nb, t, kInclusive, s);
        }
        lcp::mont_mul(pre, o, o);
      }
    }
    __syncwarp();
    if (lane < kWarps) {
#pragma unroll
      for (int w = 0; w < 8; ++w) wsum[w][lane] = o[w];
    }
  }
  __syncthreads();
  uint32_t off[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) off[w] = wsum[w][warp];
  lcp::mont_mul(off, ex, off);
#pragma unroll
  for (int q = 0; q < kPerThread; q += kRun) {
    uint32_t v[kRun][8];
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
#pragma unroll
      for (int w = 0; w < 8; ++w) v[r][w] = runs[q + r][w][tid];
      lcp::mont_mul(off, v[r], v[r]);
    }
    store_run<kVec>(out, n, e0 + q, v);
  }
}

unsigned int blocks(long long n, long long per_block) {
  return (unsigned int)((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// x, out: (16, n) limbs; k = ceil(n / kInvTile) tiles; tot, pre: (16, k)
// scratch; q totals a thread of inv_totals.
int lcp_batch_inverse(const void* x, void* out, long long n, long long k, long long q,
                      void* tot, void* pre, void* stream) {
  if (n <= 0) return 0;
  if (k != (n + kInvTile - 1) / kInvTile || q < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = n % kRun == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (vec) {
    inv_reduce_kernel<true><<<(unsigned int)k, kInvThreads, 0, s>>>(
        (const int32_t*)x, n, (int32_t*)tot, k);
  } else {
    inv_reduce_kernel<false><<<(unsigned int)k, kInvThreads, 0, s>>>(
        (const int32_t*)x, n, (int32_t*)tot, k);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  inv_totals_kernel<<<blocks(k, kMidThreads * q), kMidThreads, 0, s>>>(
      (int32_t*)tot, (int32_t*)pre, k, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (vec) {
    inv_apply_kernel<true><<<(unsigned int)k, kInvThreads, 0, s>>>(
        (const int32_t*)x, (int32_t*)out, n, (const int32_t*)tot, k);
  } else {
    inv_apply_kernel<false><<<(unsigned int)k, kInvThreads, 0, s>>>(
        (const int32_t*)x, (int32_t*)out, n, (const int32_t*)tot, k);
  }
  return (int)cudaGetLastError();
}

// x, out: (16, n) limbs; nb = ceil(n / kTile) tiles; status:
// flag_words(nb) + kSlotWords * nb int32 words of scratch, unused (may be
// null) for a single tile.
int lcp_prefix_product(const void* x, void* out, long long n, long long nb, void* status,
                       void* stream) {
  if (n <= 0) return 0;
  if (nb != (n + kTile - 1) / kTile) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* st = nullptr;
  if (nb > 1) {
    if (status == nullptr) return (int)cudaErrorInvalidValue;
    st = (int32_t*)status;
    // the counter and the flags; the slots are read only behind a flag
    const cudaError_t err = cudaMemsetAsync(st, 0, flag_words(nb) * sizeof(int32_t), s);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = n % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (vec) {
    prefix_product_kernel<true><<<(unsigned int)nb, kTileThreads, 0, s>>>(
        (const int32_t*)x, (int32_t*)out, n, st, nb);
  } else {
    prefix_product_kernel<false><<<(unsigned int)nb, kTileThreads, 0, s>>>(
        (const int32_t*)x, (int32_t*)out, n, st, nb);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
