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
// each, which stays below the bytes' time.  The totals add 64 B a chunk or a
// tile.
//
// What the design does about it: the running product of a scan stays in a
// thread's registers (8 words, as lax.scan keeps its carry), and every
// element is read coalesced.
//
// H5, three launches.  Any partition into chunks gives the same inverses, so
// the chunks are chunk-major as in the plain version: thread j of k walks
// the elements j, j + k, j + 2k, ..., and neighbouring threads read
// neighbouring words.  (1) inv_forward writes each chunk's running products
// into `out` and the chunk total into `tot`; (2) inv_totals inverts the k
// totals in place: a block takes kMidThreads * q of them, each thread q, a
// product tree of the block's kMidThreads partial products in shared memory,
// one Fermat inversion at its root (251 squarings, 193 products) and the tree
// back down; (3) inv_backward walks each chunk backwards from the inverted
// total and overwrites the running products with the inverses.  No scratch of
// size n: only 2 k totals.  Zeros are taken as one on the way and map to
// zero, as in lambdaworks' inplace_batch_inverse.  The loads of the next step
// are issued before the product of this one, so that a thread's chain keeps a
// step's loads in flight.
//
// H6, three launches (one when n <= kTile).  A prefix product needs
// contiguous ranges: a block takes a tile of kTile elements.  (1)
// prefix_reduce: each tile's total, read coalesced; (2) prefix_totals: one
// block scans the tile totals in place, a tile of them at a time with the
// running product carried between them; (3) prefix_scan: each block loads
// its tile coalesced into shared memory, each thread scans its kPerThread
// consecutive elements there, a warp scan (shuffles) and a scan of the warp
// totals give each thread its offset, times the inclusive total of the tiles
// before; the tile goes back out coalesced.  Bytes: the input read twice and
// the output written once.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;      // H5's chunk passes: threads a block
constexpr int kMidThreads = 256;   // H5's totals: leaves of a block's tree
constexpr int kTileThreads = 256;  // H6: threads a tile
constexpr int kPerThread = 4;      // H6: consecutive elements a thread scans
constexpr int kTile = kTileThreads * kPerThread;
constexpr int kWarps = kTileThreads / 32;
// a tile in shared memory, word-major, one pad word after every kPerThread
// elements, so that the threads' strided reads of step (3) hit 32 banks
constexpr int kPitch = kTile + kTile / kPerThread;
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

// a^(p - 2), left to right: p - 2 = 2^251 + 2^196 + (2^192 - 1), so after the
// leading bit every step squares and bits 196 and 0..191 also multiply.
__device__ __forceinline__ void fermat_inv(const uint32_t a[8], uint32_t r[8]) {
  uint32_t acc[8];
  copy8(acc, a);
#pragma unroll 1
  for (int bit = 250; bit >= 0; --bit) {
    lcp::mont_mul(acc, acc, acc);
    if (bit < 192 || bit == 196) lcp::mont_mul(acc, a, acc);
  }
  copy8(r, acc);
}

// ---------------------------------------------------------------------------
// H5
// ---------------------------------------------------------------------------

// Chunk j < k: out[e] = x[j] * x[j + k] * ... * x[e] (zeros as one) for its
// elements e = j + t k < n, and tot[j] = the last of them.
__global__ void __launch_bounds__(kThreads)
    inv_forward_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                       long long n, long long k, int32_t* __restrict__ tot) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= k) return;
  uint32_t acc[8], v[8], next[8];
  set_one(acc);
  lcp::load_elem(x, n, j, next);
  for (long long e = j; e < n; e += k) {
    copy8(v, next);
    if (e + k < n) lcp::load_elem(x, n, e + k, next);
    if (!is_zero(v)) lcp::mont_mul(acc, v, acc);
    lcp::store_elem(out, n, e, acc);
  }
  lcp::store_elem(tot, k, j, acc);
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
  if (i == 0) {
    node_get(node, 1, v);
    fermat_inv(v, v);
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

// Chunk j < k, from its last element down: out[e] = x[e]^-1 (0 for a zero),
// from the inverted total tinv[j] and the running products in out.
__global__ void __launch_bounds__(kThreads)
    inv_backward_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                        long long n, long long k, const int32_t* __restrict__ tinv) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= k) return;
  long long e = j + (n - 1 - j) / k * k;  // the chunk's last element
  uint32_t carry[8], xv[8], pv[8], nx[8], np[8] = {0}, r[8];
  lcp::load_elem(tinv, k, j, carry);
  lcp::load_elem(x, n, e, nx);
  if (e >= k) lcp::load_elem(out, n, e - k, np);
  for (;;) {
    const bool more = e >= k;  // an element before this one in the chunk
    copy8(xv, nx);
    copy8(pv, np);
    if (more) {
      lcp::load_elem(x, n, e - k, nx);
      if (e >= 2 * k) lcp::load_elem(out, n, e - 2 * k, np);
    }
    if (is_zero(xv)) {
#pragma unroll
      for (int w = 0; w < 8; ++w) r[w] = 0;
    } else if (more) {
      lcp::mont_mul(carry, pv, r);
      lcp::mont_mul(carry, xv, carry);
    } else {
      copy8(r, carry);
    }
    lcp::store_elem(out, n, e, r);
    if (!more) break;
    e -= k;
  }
}

// ---------------------------------------------------------------------------
// H6
// ---------------------------------------------------------------------------

__device__ __forceinline__ int slot(int e) { return e + e / kPerThread; }

__device__ __forceinline__ void tile_get(uint32_t (*tile)[kPitch], int e, uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = tile[k][slot(e)];
}

__device__ __forceinline__ void tile_put(uint32_t (*tile)[kPitch], int e,
                                         const uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) tile[k][slot(e)] = w[k];
}

// Inclusive product scan over the lanes of a warp.
__device__ __forceinline__ void warp_scan(uint32_t acc[8]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
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

// dst[base + e] = carry * src[base] * ... * src[base + e] for the elements
// e < kTile of the tile with base + e < n (the rest taken as one);
// `total` gets carry times the tile's product.  src may be dst.
__device__ void scan_tile(const int32_t* src, int32_t* dst, long long n, long long base,
                          const uint32_t carry[8], uint32_t (*tile)[kPitch],
                          uint32_t (*wsum)[kWarps], uint32_t* total) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t acc[8], v[8], ex[8];
#pragma unroll
  for (int it = 0; it < kPerThread; ++it) {  // coalesced in
    const int e = it * kTileThreads + tid;
    if (base + e < n) {
      lcp::load_elem(src, n, base + e, v);
    } else {
      set_one(v);
    }
    tile_put(tile, e, v);
  }
  __syncthreads();
  const int e0 = tid * kPerThread;  // the thread's consecutive elements
  tile_get(tile, e0, acc);
#pragma unroll
  for (int t = 1; t < kPerThread; ++t) {
    tile_get(tile, e0 + t, v);
    lcp::mont_mul(acc, v, acc);
    tile_put(tile, e0 + t, acc);
  }
  warp_scan(acc);
  lane_before(acc, ex);
  if (lane == 31) {
#pragma unroll
    for (int w = 0; w < 8; ++w) wsum[w][warp] = acc[w];
  }
  __syncthreads();
  if (warp == 0) {  // the warps' offsets, times the carry
    uint32_t s[8], o[8];
    if (lane < kWarps) {
#pragma unroll
      for (int w = 0; w < 8; ++w) s[w] = wsum[w][lane];
    } else {
      set_one(s);
    }
    warp_scan(s);
    lane_before(s, o);
    lcp::mont_mul(carry, o, o);
    if (lane == kWarps - 1) {
      lcp::mont_mul(carry, s, v);
      copy8(total, v);
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
  for (int t = 0; t < kPerThread; ++t) {
    tile_get(tile, e0 + t, v);
    lcp::mont_mul(off, v, v);
    tile_put(tile, e0 + t, v);
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kPerThread; ++it) {  // coalesced out
    const int e = it * kTileThreads + tid;
    if (base + e < n) {
      tile_get(tile, e, v);
      lcp::store_elem(dst, n, base + e, v);
    }
  }
  __syncthreads();  // the tile and wsum are free again
}

// tot[b] = the product of tile b's elements.
__global__ void __launch_bounds__(kTileThreads)
    prefix_reduce_kernel(const int32_t* __restrict__ x, long long n,
                         int32_t* __restrict__ tot, long long nb) {
  __shared__ uint32_t wsum[8][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)blockIdx.x * kTile;
  uint32_t acc[8], v[8];
  set_one(acc);
#pragma unroll
  for (int it = 0; it < kPerThread; ++it) {
    const long long e = base + it * kTileThreads + tid;
    if (e < n) {
      lcp::load_elem(x, n, e, v);
      lcp::mont_mul(acc, v, acc);
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off /= 2) {
#pragma unroll
    for (int w = 0; w < 8; ++w) v[w] = __shfl_xor_sync(kFull, acc[w], off);
    lcp::mont_mul(acc, v, acc);
  }
  if (lane == 0) {
#pragma unroll
    for (int w = 0; w < 8; ++w) wsum[w][warp] = acc[w];
  }
  __syncthreads();
  if (tid == 0) {
    for (int u = 1; u < kWarps; ++u) {
#pragma unroll
      for (int w = 0; w < 8; ++w) v[w] = wsum[w][u];
      lcp::mont_mul(acc, v, acc);
    }
    lcp::store_elem(tot, nb, blockIdx.x, acc);
  }
}

// tot <- its inclusive prefix products, by one block, a tile at a time.
__global__ void __launch_bounds__(kTileThreads)
    prefix_totals_kernel(int32_t* tot, long long nb) {
  __shared__ uint32_t tile[8][kPitch];
  __shared__ uint32_t wsum[8][kWarps];
  __shared__ uint32_t total[8];
  uint32_t carry[8];
  set_one(carry);
  for (long long base = 0; base < nb; base += kTile) {
    scan_tile(tot, tot, nb, base, carry, tile, wsum, total);
    copy8(carry, total);
    __syncthreads();  // every thread has read `total` before the next tile
  }
}

// out = the inclusive prefix products of x; tile b starts from tinc[b - 1],
// the product of the tiles before (tinc null: a single tile).
__global__ void __launch_bounds__(kTileThreads)
    prefix_scan_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                       long long n, const int32_t* __restrict__ tinc, long long nb) {
  __shared__ uint32_t tile[8][kPitch];
  __shared__ uint32_t wsum[8][kWarps];
  __shared__ uint32_t total[8];
  uint32_t carry[8];
  if (blockIdx.x == 0 || tinc == nullptr) {
    set_one(carry);
  } else {
    lcp::load_elem(tinc, nb, blockIdx.x - 1, carry);
  }
  scan_tile(x, out, n, (long long)blockIdx.x * kTile, carry, tile, wsum, total);
}

unsigned int blocks(long long n, long long per_block) {
  return (unsigned int)((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// x, out: (16, n) limbs; k chunks (1 <= k <= n); tot, pre: (16, k) scratch;
// q totals a thread of inv_totals.
int lcp_batch_inverse(const void* x, void* out, long long n, long long k, long long q,
                      void* tot, void* pre, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > n || q < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  inv_forward_kernel<<<blocks(k, kThreads), kThreads, 0, s>>>(
      (const int32_t*)x, (int32_t*)out, n, k, (int32_t*)tot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  inv_totals_kernel<<<blocks(k, kMidThreads * q), kMidThreads, 0, s>>>(
      (int32_t*)tot, (int32_t*)pre, k, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  inv_backward_kernel<<<blocks(k, kThreads), kThreads, 0, s>>>(
      (const int32_t*)x, (int32_t*)out, n, k, (const int32_t*)tot);
  return (int)cudaGetLastError();
}

// x, out: (16, n) limbs; tot: (16, ceil(n / kTile)) scratch, unused (may be
// null) for a single tile.
int lcp_prefix_product(const void* x, void* out, long long n, void* tot, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long nb = (n + kTile - 1) / kTile;
  if (nb == 1) {
    prefix_scan_kernel<<<1, kTileThreads, 0, s>>>((const int32_t*)x, (int32_t*)out, n,
                                                  nullptr, 1);
    return (int)cudaGetLastError();
  }
  if (tot == nullptr) return (int)cudaErrorInvalidValue;
  prefix_reduce_kernel<<<(unsigned int)nb, kTileThreads, 0, s>>>(
      (const int32_t*)x, n, (int32_t*)tot, nb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  prefix_totals_kernel<<<1, kTileThreads, 0, s>>>((int32_t*)tot, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  prefix_scan_kernel<<<(unsigned int)nb, kTileThreads, 0, s>>>(
      (const int32_t*)x, (int32_t*)out, n, (const int32_t*)tot, nb);
  return (int)cudaGetLastError();
}

}  // extern "C"
