// H3 `ntt_dif_stages` and H4 `ntt_dif_local`: the port's NTT.
//
// Together they replace the JAX package's five TPU NTT schedules:
// ntt/fused.py:_gpair_kernel, _gsingle_kernel and _local_kernel_body, and
// field/pallas_mul.py:_butterfly_kernel and _butterfly2_kernel.  All compute
// the same values (evaluate(c)[i] = p(w^i), natural order), so one schedule
// serves: decimation in frequency (natural input), a few passes of several
// stages each, the last of which writes natural order itself.
//
// Both kernels work on a tile of up to 2^TILE_LOG points held in shared
// memory as 8 packed 32-bit words a point (word-major planes, one pad word
// per 32, 66 KB: three blocks share an SM).  A tile is 2^r rows by T
// columns.  The r stages of the pass pair rows; a column is carried along.
// Two stages go through registers per shared-memory round trip (a thread
// holds 4 points), so r stages cost ceil(r/2) round trips and barriers.
//
//   H3  rows are 2^(log_m_hi - r + 1) elements apart, columns are T
//       consecutive elements (a warp reads and writes runs of T words in
//       each limb plane; T = 2^TILE_LOG / 2^r, 16 for r = 7).  src may
//       differ from dst, so the first pass reads the caller's tensor.  The
//       column of the batch is the fastest block index: the blocks that
//       need one twiddle tile run together and share it in the L2.
//   H4  rows are the 2^log_chunk consecutive elements of a chunk (every
//       stage with m < 2^log_chunk), columns are G chunks whose indices
//       differ only in their top bits.  In place it leaves the DIF's
//       bit-reversed order; with `natural` it writes element (chunk c,
//       local l) to rev(l) * n_chunks + rev(c): for one l the G chunks of a
//       block fill G consecutive words, so the bit-reverse pass is gone and
//       the writes stay runs of G words (16 at log_chunk = 7).  Resident
//       points bound G * 2^log_chunk <= 2^TILE_LOG: a 10-stage chunk leaves
//       G = 2, which is why the last pass of a long transform takes 7.
//       Blocks take their chunks in bit-reversed turn, so that blocks that
//       run together write neighbouring runs.  The product by w = 1 of the
//       last stage (and of w_4^0) is skipped.
//
// Data: (16, B, n) int32 limb tensors, contiguous; `total` = B * n is the
// limb stride.  Twiddles: a packed table of 8 words per entry, entry
// m + j = w_{2m}^j for every power of two m < n and j < m (entry 0 unused),
// read with two 16-byte loads.
//
// Bound on the H100: a butterfly needs 72 multiply-adds of 32 x 32 + 64 bits
// and some 40 additions, so a pass of up to 10 stages is bound by bytes
// (128 B a point in and out) and only the whole transform by operations.
// What the kernels reach is set by the multiplier: the 80 multiply-adds of a
// butterfly carry, and the card runs a carried one at under half the rate of
// one without (tools/bench_torch_ntt.py --pipes), so removing additions buys
// nothing.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

#define LOCAL_LOG 10                 // largest chunk of H4
#define TILE_LOG 11                  // points resident in a block
#define TILE (1 << TILE_LOG)
#define PLANE (TILE + TILE / 32)     // words of one plane, padded
#define TILE_BYTES (8 * PLANE * 4)
#define THREADS 256

namespace {

__device__ __forceinline__ int phys(int s) { return s + (s >> 5); }

__device__ __forceinline__ int rev_bits(int x, int bits) {
  return bits == 0 ? 0 : (int)(__brev((unsigned int)x) >> (32 - bits));
}

__device__ __forceinline__ void sm_get(const uint32_t* sm, int s, uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = sm[k * PLANE + s];
}

__device__ __forceinline__ void sm_put(uint32_t* sm, int s, const uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) sm[k * PLANE + s] = w[k];
}

__device__ __forceinline__ void load_twiddle(const uint32_t* twp, long long idx,
                                             uint32_t w[8]) {
  const uint4* p = reinterpret_cast<const uint4*>(twp) + 2 * idx;
  uint4 a = __ldg(p);
  uint4 b = __ldg(p + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// u <- u + v, v <- (u - v) * w
__device__ __forceinline__ void dif_butterfly(uint32_t u[8], uint32_t v[8],
                                              const uint32_t w[8]) {
  uint32_t s[8], d[8];
  lcp::add_mod(u, v, s);
  lcp::sub_mod(u, v, d);
  lcp::mont_mul(d, w, v);
#pragma unroll
  for (int k = 0; k < 8; ++k) u[k] = s[k];
}

// the same with w = 1
__device__ __forceinline__ void dif_butterfly_one(uint32_t u[8], uint32_t v[8]) {
  uint32_t s[8], d[8];
  lcp::add_mod(u, v, s);
  lcp::sub_mod(u, v, d);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    u[k] = s[k];
    v[k] = d[k];
  }
}

// Tile point i of a block -> (row, col), rows or columns fastest.
__device__ __forceinline__ void tile_point(int i, int r, int log_t, bool row_fast,
                                           int& row, int& col) {
  if (row_fast) {
    row = i & ((1 << r) - 1);
    col = i >> r;
  } else {
    col = i & ((1 << log_t) - 1);
    row = i >> log_t;
  }
}

__device__ __forceinline__ void tile_load(uint32_t* sm, const int32_t* src, long long total,
                                          long long base, long long row_stride,
                                          long long col_stride, int r, int log_t,
                                          bool row_fast) {
  const int points = 1 << (r + log_t);
  for (int i = threadIdx.x; i < points; i += blockDim.x) {
    int row, col;
    tile_point(i, r, log_t, row_fast, row, col);
    uint32_t w[8];
    lcp::load_elem(src, total, base + row * row_stride + col * col_stride, w);
    sm_put(sm, phys((row << log_t) | col), w);
  }
}

// Point i of the destination tile; with `reversed` it holds the tile's point
// (rev(row), rev(col)).
__device__ __forceinline__ void tile_store(const uint32_t* sm, int32_t* dst, long long total,
                                           long long base, long long row_stride,
                                           long long col_stride, int r, int log_t,
                                           bool row_fast, bool reversed) {
  const int points = 1 << (r + log_t);
  for (int i = threadIdx.x; i < points; i += blockDim.x) {
    int row, col;
    tile_point(i, r, log_t, row_fast, row, col);
    const int srow = reversed ? rev_bits(row, r) : row;
    const int scol = reversed ? rev_bits(col, log_t) : col;
    uint32_t w[8];
    sm_get(sm, phys((srow << log_t) | scol), w);
    lcp::store_elem(dst, total, base + row * row_stride + col * col_stride, w);
  }
}

// The r DIF stages of a tile, highest row bit first.  The stage that pairs
// rows differing in bit k has half-size m = 2^(log_m_lo + k); the twiddle of
// a pair is entry m + ((row mod 2^k) << log_m_lo) + low, where low =
// low_base + col (H3) or 0 (H4: col_tw = 0).
__device__ __forceinline__ void tile_stages(uint32_t* sm, const uint32_t* twp, int r,
                                            int log_t, int log_m_lo, long long low_base,
                                            int col_tw) {
  const int col_mask = (1 << log_t) - 1;
  int k = r - 1;
  for (; k >= 1; k -= 2) {
    // stages k and k - 1 on the 4 rows row0 + {0, 1, 2, 3} * h
    const int h = 1 << (k - 1);
    const int quads = 1 << (r + log_t - 2);
    const long long m = 1LL << (log_m_lo + k);
    for (int q = threadIdx.x; q < quads; q += blockDim.x) {
      const int col = q & col_mask;
      const int rq = q >> log_t;
      const int lowpart = rq & (h - 1);
      const int row0 = ((rq >> (k - 1)) << (k + 1)) | lowpart;
      const int s0 = phys((row0 << log_t) | col);
      const int s1 = phys(((row0 + h) << log_t) | col);
      const int s2 = phys(((row0 + 2 * h) << log_t) | col);
      const int s3 = phys(((row0 + 3 * h) << log_t) | col);
      uint32_t a0[8], a1[8], a2[8], a3[8], w[8];
      sm_get(sm, s0, a0);
      sm_get(sm, s1, a1);
      sm_get(sm, s2, a2);
      sm_get(sm, s3, a3);
      const long long low = low_base + (col_tw ? col : 0);
      const long long j0 = ((long long)lowpart << log_m_lo) + low;
      const long long j1 = ((long long)(lowpart + h) << log_m_lo) + low;
      if (m == 2) {
        // m = 2 and m = 1: the twiddles are 1, w_4, 1
        dif_butterfly_one(a0, a2);
        load_twiddle(twp, m + j1, w);
        dif_butterfly(a1, a3, w);
        dif_butterfly_one(a0, a1);
        dif_butterfly_one(a2, a3);
      } else {
        load_twiddle(twp, m + j0, w);
        dif_butterfly(a0, a2, w);
        load_twiddle(twp, m + j1, w);
        dif_butterfly(a1, a3, w);
        load_twiddle(twp, (m >> 1) + j0, w);
        dif_butterfly(a0, a1, w);
        dif_butterfly(a2, a3, w);
      }
      sm_put(sm, s0, a0);
      sm_put(sm, s1, a1);
      sm_put(sm, s2, a2);
      sm_put(sm, s3, a3);
    }
    __syncthreads();
  }
  if (k == 0) {
    // the last stage alone: rows 2 * rp and 2 * rp + 1, m = 2^log_m_lo
    const int pairs = 1 << (r + log_t - 1);
    const long long m = 1LL << log_m_lo;
    for (int b = threadIdx.x; b < pairs; b += blockDim.x) {
      const int col = b & col_mask;
      const int row0 = (b >> log_t) << 1;
      const int s0 = phys((row0 << log_t) | col);
      const int s1 = phys(((row0 + 1) << log_t) | col);
      uint32_t u[8], v[8], w[8];
      sm_get(sm, s0, u);
      sm_get(sm, s1, v);
      if (m == 1) {
        dif_butterfly_one(u, v);
      } else {
        load_twiddle(twp, m + low_base + (col_tw ? col : 0), w);
        dif_butterfly(u, v, w);
      }
      sm_put(sm, s0, u);
      sm_put(sm, s1, v);
    }
    __syncthreads();
  }
}

// H3: stages log_m_hi .. log_m_hi - r + 1 of every column.
__global__ void __launch_bounds__(THREADS, 3)
ntt_dif_stages_kernel(const int32_t* src, int32_t* dst, long long total, int log_n,
                      long long n_cols, int log_m_hi, int r, int log_t,
                      const uint32_t* twp) {
  extern __shared__ uint32_t sm[];
  const int log_m_lo = log_m_hi - r + 1;
  const long long bcol = blockIdx.x % n_cols;
  const long long tile = blockIdx.x / n_cols;
  const long long mid = tile & ((1LL << (log_m_lo - log_t)) - 1);
  const long long hi = tile >> (log_m_lo - log_t);
  const long long base = (bcol << log_n) + (hi << (log_m_hi + 1)) + (mid << log_t);
  const long long row_stride = 1LL << log_m_lo;
  tile_load(sm, src, total, base, row_stride, 1, r, log_t, false);
  __syncthreads();
  tile_stages(sm, twp, r, log_t, log_m_lo, mid << log_t, 1);
  tile_store(sm, dst, total, base, row_stride, 1, r, log_t, false, false);
}

// H4: every stage with m < 2^r on the 2^g chunks (c_hi, c_low), c_hi = 0 ..
// 2^g - 1 the top bits of the chunk index.
__global__ void __launch_bounds__(THREADS, 3)
ntt_dif_local_kernel(const int32_t* src, int32_t* dst, long long total, int log_n,
                     long long n_cols, int r, int g, int natural,
                     const uint32_t* twp) {
  extern __shared__ uint32_t sm[];
  const int low_bits = log_n - r - g;
  const long long bcol = blockIdx.x % n_cols;
  // natural order: blocks that run together write neighbouring runs
  const long long turn = blockIdx.x / n_cols;
  const long long c_low = natural ? rev_bits((int)turn, low_bits) : turn;
  const long long base = (bcol << log_n) + (c_low << r);
  const long long chunk_stride = 1LL << (log_n - g);
  tile_load(sm, src, total, base, 1, chunk_stride, r, g, true);
  __syncthreads();
  tile_stages(sm, twp, r, g, 0, 0, 0);
  if (natural) {
    const long long out = (bcol << log_n) + (turn << g);
    tile_store(sm, dst, total, out, 1LL << (log_n - r), 1, r, g, false, true);
  } else {
    tile_store(sm, dst, total, base, 1, chunk_stride, r, g, true, false);
  }
}

template <typename Kernel>
cudaError_t allow_tile(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              TILE_BYTES);
}

}  // namespace

extern "C" {

// Stages log_m_hi .. log_m_hi - n_stages + 1 of src (16, n_cols, 2^log_n) into
// dst (the same tensor or another of that shape).
int lcp_ntt_dif_stages(const void* src, void* dst, long long n_cols, int log_n,
                       int log_m_hi, int n_stages, const void* twp, void* stream) {
  if (n_cols < 1 || log_n < 1 || log_n > 30 || n_stages < 1 || n_stages > TILE_LOG ||
      log_m_hi >= log_n || log_m_hi - n_stages + 1 < 0)
    return (int)cudaErrorInvalidValue;
  const int log_m_lo = log_m_hi - n_stages + 1;
  int log_t = TILE_LOG - n_stages;
  if (log_t > log_m_lo) log_t = log_m_lo;
  const long long blocks = n_cols << (log_n - n_stages - log_t);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_tile(ntt_dif_stages_kernel);
  if (err != cudaSuccess) return (int)err;
  ntt_dif_stages_kernel<<<(unsigned int)blocks, THREADS, TILE_BYTES, (cudaStream_t)stream>>>(
      (const int32_t*)src, (int32_t*)dst, n_cols << log_n, log_n, n_cols, log_m_hi,
      n_stages, log_t, (const uint32_t*)twp);
  return (int)cudaGetLastError();
}

// Every stage with m < 2^log_chunk; natural != 0 writes natural order into
// dst, which then must not be src unless log_chunk == log_n.
int lcp_ntt_dif_local(const void* src, void* dst, long long n_cols, int log_n,
                      int log_chunk, int natural, const void* twp, void* stream) {
  if (n_cols < 1 || log_n < 1 || log_n > 30 || log_chunk < 1 || log_chunk > LOCAL_LOG ||
      log_chunk > log_n || (natural && src == dst && log_chunk != log_n))
    return (int)cudaErrorInvalidValue;
  int g = TILE_LOG - log_chunk;
  if (g > log_n - log_chunk) g = log_n - log_chunk;
  const long long blocks = n_cols << (log_n - log_chunk - g);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_tile(ntt_dif_local_kernel);
  if (err != cudaSuccess) return (int)err;
  ntt_dif_local_kernel<<<(unsigned int)blocks, THREADS, TILE_BYTES, (cudaStream_t)stream>>>(
      (const int32_t*)src, (int32_t*)dst, n_cols << log_n, log_n, n_cols, log_chunk, g,
      natural, (const uint32_t*)twp);
  return (int)cudaGetLastError();
}

}  // extern "C"
