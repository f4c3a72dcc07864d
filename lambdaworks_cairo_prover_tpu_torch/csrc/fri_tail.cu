// K4 `fri_tail`: the FRI commit phase's last layers and its final fold, in
// one launch of one cluster of blocks.
//
// It replaces no Pallas kernel.  The JAX package folds, transforms and
// commits the FRI layers of 4,096 points or fewer on the host, in Python
// integers (prover/prove.py: _host_fold, _host_evaluate_offset_fft,
// _HostMerkle), and the port did the same: some 116 ms of host time a
// 2^19-row Cairo job, with the card idle.  K4 starts from the FRI chain's
// last folded coefficients and the transcript state, both on the card, and
// for each layer (2^log_ds0 points, then half as many, ...):
//   1. draws zeta: state' = keccak256(state || the layer before's root),
//      zeta = state' read as a big-endian integer, masked to 251 bits, in
//      Montgomery form (transcript/fiat_shamir.py, and the chain's draw);
//   2. folds the coefficients: c'_i = c_2i + zeta * c_2i+1;
//   3. evaluates them on the layer's coset: c'_i * offset^i, zeros up to the
//      layer's size, and a radix-2 transform in shared memory (bit-reversed
//      scatter, decimation in time, natural order out);
//   4. writes the evaluations (Montgomery limbs), hashes each point's 32-byte
//      big-endian encoding (canonical) as a leaf and builds the layer's
//      Merkle tree;
//   5. keeps the root for the next draw.
// Then one more draw and the final fold: the last value, canonical, as the
// 32 little-endian bytes of a row.
//
// Bound: latency.  The work is small: from 2^12 points over ten layers,
// 8,184 leaves and 8,174 nodes (some 16,360 permutations of 4,491 32-bit
// instructions: 0.58 ms of one SM), 45 k butterflies, 1 MB written.  But
// each layer waits for the root of the one before, through 10 x (12
// transform stages + 12 tree levels) barriers and the serial tops of the
// trees.  So one cluster of blocks (one a SM), and the host reads nothing
// until the end.  Block 0 keeps the layer in its shared memory (8 words a
// point in word-major planes, a pad word per 32: 135 KB at 4,096 points)
// and the folded coefficients in two more planes (read one, write the
// other), and draws, folds and transforms alone; the blocks of the cluster
// share the Keccak work, each a slice of the leaves and its subtree, and
// block 0 hashes the levels above the slices' roots.  The trees' tops and
// the draws are serial: a thread a message takes some 6 us a permutation
// (a warp's 32-bit integer instructions issue at half rate), so a level or
// draw of at most kWarpMessages messages goes a warp a message
// (keccak_f_warp).  512 threads a block: Keccak's state takes some 100
// registers a thread, and 1,024 threads leave 64.  On the H100 at the
// cells' tail (ten layers from 4,096 points): 1.27 ms a launch in one block
// with a thread a message, 1.03 ms in clusters of 8, 0.65 ms with the warp
// hashing too.
//
// Layout: coeffs (16, 2^(n_layers + 1)) int32 Montgomery limbs, limb stride
// coeff_stride; state and root 4 u64 lanes; powers the packed (n, 8) table of
// each layer's offset powers, layer after layer (2^n_layers of them for the
// first); twiddles the packed (>= 2^log_ds0, 8) NTT table (ntt.cu's: entry
// m + j = w_{2m}^j).  Out: evals (16, sum of the layers' sizes) Montgomery
// limbs; levels (sum of 2 size - 1, 4) digests, each layer's leaves then its
// tree's levels up to the root; rows (n_layers + 1, 4), the roots and the
// last value; states (n_layers + 1, 4), the state after each draw.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "field.cuh"
#include "keccak.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTailThreads = 512;
constexpr int kTailMaxLog = 12;  // the largest first layer: 2^12 points
constexpr int kWarps = kTailThreads / 32;
// a block hashes a level of at most this many messages a warp a message
// (keccak_f_warp), a larger one a thread a message
constexpr int kWarpMessages = 2 * kWarps;

// keccak_f_warp's lane constants: the rho amount of state lane x + 5y, and
// the lane that pi moves to lane d (b[y + 5((2x + 3y) % 5)] = a[x + 5y])
__constant__ int kRho[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                             25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
__constant__ int kPiSrc[25] = {0, 6,  12, 18, 24, 3, 9,  10, 16, 22, 1, 7, 13,
                               19, 20, 4, 5,  11, 17, 23, 2, 8, 14, 15, 21};

// R^2 mod p (field/params.py: R2), 32-bit words little-endian: the factor
// into Montgomery form
__constant__ uint32_t kR2[8] = {0x7e000401u, 0xfffffd73u, 0x330fffffu, 0x00000001u,
                                0xff6f8000u, 0xffffffffu, 0x5e008810u, 0x07ffd4abu};

__device__ __forceinline__ int phys(int s) { return s + (s >> 5); }

__device__ __forceinline__ int rev_bits(int x, int bits) {
  return bits == 0 ? 0 : (int)(__brev((unsigned int)x) >> (32 - bits));
}

__device__ __forceinline__ void sm_get(const uint32_t* sm, int plane, int s, uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = sm[k * plane + s];
}

__device__ __forceinline__ void sm_put(uint32_t* sm, int plane, int s, const uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) sm[k * plane + s] = w[k];
}

// entry idx of a packed (n, 8) table, two 16-byte loads
__device__ __forceinline__ void load_entry(const uint32_t* tab, int idx, uint32_t w[8]) {
  const uint4* p = reinterpret_cast<const uint4*>(tab) + 2 * idx;
  const uint4 a = __ldg(p);
  const uint4 b = __ldg(p + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

__device__ __forceinline__ uint32_t bswap(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// out of Montgomery form: REDC(a * 1)
__device__ __forceinline__ void from_mont(const uint32_t a[8], uint32_t r[8]) {
  const uint32_t one[8] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  lcp::mont_mul(a, one, r);
}

// r = a + zeta * b
__device__ __forceinline__ void fold(const uint32_t a[8], const uint32_t b[8],
                                     const uint32_t zeta[8], uint32_t r[8]) {
  uint32_t zb[8];
  lcp::mont_mul(b, zeta, zb);
  lcp::add_mod(a, zb, r);
}

// zeta <- the state as a big-endian integer, its top 5 bits cleared (<
// 2^251 < p), in Montgomery form
__device__ void state_to_zeta(const u64 s[4], uint32_t zeta[8]) {
  uint32_t w[8], r2[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // integer words 2i, 2i + 1: digest bytes 28-8i .. 31-8i and 24-8i ..
    // 27-8i, the high and low halves of lane 3 - i, byte-swapped
    w[2 * i] = bswap((uint32_t)(s[3 - i] >> 32));
    w[2 * i + 1] = bswap((uint32_t)s[3 - i]);
  }
  w[7] &= 0x07FFFFFFu;
#pragma unroll
  for (int k = 0; k < 8; ++k) r2[k] = kR2[k];
  lcp::mont_mul(w, r2, zeta);
}

// rotate left by r, which differs from lane to lane
__device__ __forceinline__ u64 rotl_var(u64 x, int r) {
  const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  const uint32_t l2 = r >= 32 ? hi : lo, h2 = r >= 32 ? lo : hi;
  const int s = r & 31;
  return ((u64)__funnelshift_l(l2, h2, s) << 32) | __funnelshift_l(h2, l2, s);
}

__device__ __forceinline__ u64 shfl(u64 v, int lane) {
  return __shfl_sync(0xffffffffu, v, lane);
}

// keccak-f[1600] on one message by the calling warp: lane l < 25 holds
// state lane l (x + 5y) and gets it back permuted; lanes 25..31 carry
// nothing that is read.  A thread a message is bound by the issue of its
// ~4,500 integer instructions (some 6 us for a lone warp); here a round is
// some 15 integer instructions a lane and 9 shuffles of 64 bits, for the
// levels and draws that have too few messages to fill the block.
__device__ u64 keccak_f_warp(u64 a) {
  const int l = threadIdx.x & 31;
  const int m = l < 25 ? l : 0;
  const int x = m % 5, row = m - x;
  const int left = row + (x + 4) % 5, right = row + (x + 1) % 5, right2 = row + (x + 2) % 5;
  const int rho = kRho[m], src = kPiSrc[m];
#pragma unroll 1
  for (int round = 0; round < 24; ++round) {
    // theta: the column's parity, then a ^= c[x - 1] ^ rotl(c[x + 1], 1)
    const u64 c = a ^ shfl(a, (m + 5) % 25) ^ shfl(a, (m + 10) % 25) ^
                  shfl(a, (m + 15) % 25) ^ shfl(a, (m + 20) % 25);
    a ^= shfl(c, left) ^ rotl(shfl(c, right), 1);
    // rho, then pi from the source lane
    const u64 b = shfl(rotl_var(a, rho), src);
    // chi within the row, iota on lane 0
    a = b ^ (~shfl(b, right) & shfl(b, right2));
    if (l == 0) a ^= kRoundConstants[round];
  }
  return a;
}

// keccak256 of the 32-byte big-endian encoding of a canonical element:
// message lane j is integer words 7 - 2j and 6 - 2j, each byte-swapped
__device__ __forceinline__ void hash_felt(const uint32_t w[8], u64* out) {
  u64 s[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) s[i] = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    s[j] = ((u64)bswap(w[6 - 2 * j]) << 32) | bswap(w[7 - 2 * j]);
  s[4] = 0x01;  // a 32-byte message
  s[kRate - 1] = kPadLast;
  keccak_f(s);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = s[j];
}

// a Merkle node: keccak256(left || right) of the two digests at in, read
// from L2 (another block of the cluster may have written them)
__device__ __forceinline__ void hash_pair(const u64* in, u64* out) {
  u64 s[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) s[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = __ldcg(in + i);
  s[8] = 0x01;  // a 64-byte message
  s[kRate - 1] = kPadLast;
  keccak_f(s);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = s[j];
}

// element idx of (16, ...) limbs with limb stride ls, read from L2
__device__ __forceinline__ void load_elem_cg(const int32_t* base, long long ls,
                                             long long idx, uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t lo = (uint32_t)__ldcg(base + (2 * k) * ls + idx);
    const uint32_t hi = (uint32_t)__ldcg(base + (2 * k + 1) * ls + idx);
    w[k] = (lo & 0xFFFFu) | (hi << 16);
  }
}

// hash_pair by the calling warp
__device__ __forceinline__ void hash_pair_warp(const u64* in, u64* out) {
  const int l = threadIdx.x & 31;
  u64 a = l < 8 ? __ldcg(in + l) : 0;
  if (l == 8) a = 0x01;  // a 64-byte message
  if (l == kRate - 1) a = kPadLast;
  a = keccak_f_warp(a);
  if (l < 4) out[l] = a;
}

// hash_felt by the calling warp (every lane holds w)
__device__ __forceinline__ void hash_felt_warp(const uint32_t w[8], u64* out) {
  const int l = threadIdx.x & 31;
  u64 a = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (l == j) a = ((u64)bswap(w[6 - 2 * j]) << 32) | bswap(w[7 - 2 * j]);
  if (l == 4) a = 0x01;  // a 32-byte message
  if (l == kRate - 1) a = kPadLast;
  a = keccak_f_warp(a);
  if (l < 4) out[l] = a;
}

// the block's nodes j < count of a level: out[j] = keccak256(in[2j] ||
// in[2j + 1]), a thread a node, or a warp a node on a small level
__device__ void hash_level(const u64* in, u64* out, int count) {
  const int t = threadIdx.x;
  if (count > kWarpMessages) {
#pragma unroll 1
    for (int j = t; j < count; j += kTailThreads) hash_pair(in + 8 * j, out + 4 * j);
  } else {
#pragma unroll 1
    for (int j = t >> 5; j < count; j += kWarps) hash_pair_warp(in + 8 * j, out + 4 * j);
  }
}

// the block's leaves i < count: out[i] = the leaf of evaluation idx0 + i
// (Montgomery limbs, limb stride ls) out of Montgomery form
__device__ void hash_leaves(const int32_t* evals, long long ls, long long idx0, u64* out,
                            int count) {
  const int t = threadIdx.x;
  uint32_t v[8], cv[8];
  if (count > kWarpMessages) {
#pragma unroll 1
    for (int i = t; i < count; i += kTailThreads) {
      load_elem_cg(evals, ls, idx0 + i, v);
      from_mont(v, cv);
      hash_felt(cv, out + 4 * i);
    }
  } else {
#pragma unroll 1
    for (int i = t >> 5; i < count; i += kWarps) {
      load_elem_cg(evals, ls, idx0 + i, v);
      from_mont(v, cv);
      hash_felt_warp(cv, out + 4 * i);
    }
  }
}

// One cluster of blocks.  Block 0 draws, folds and transforms each layer in
// its shared memory and writes the evaluations out; then every block hashes
// its slice of the leaves and that slice's subtree, and block 0 the levels
// above the slices' roots.  The blocks meet at two cluster barriers a layer
// (release/acquire at cluster scope: the evaluations, then the slices'
// roots), and read what another block wrote from L2.  `levels` and `evals`
// are written and read back in the launch, so neither is const nor
// __restrict__.
__global__ void __launch_bounds__(kTailThreads, 1)
fri_tail_kernel(const int32_t* __restrict__ coeffs, long long coeff_stride,
                const u64* __restrict__ state_in, const u64* __restrict__ root_in,
                const uint32_t* __restrict__ powers, const uint32_t* __restrict__ twiddles,
                int n_layers, int log_ds0, int32_t* evals, u64* levels,
                u64* __restrict__ rows, u64* __restrict__ states) {
  extern __shared__ uint32_t smem[];
  __shared__ u64 state[4], root[4];
  __shared__ uint32_t zeta_sm[8];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const int t = threadIdx.x;
  const int ds0 = 1 << log_ds0, c0 = 1 << n_layers;
  const int plane = phys(ds0);
  uint32_t* x = smem;  // the layer: 8 planes of `plane` words
  // the folded coefficients, 8 planes of c0 words each: a layer reads one
  // and writes the other
  uint32_t* const coef0 = smem + 8 * plane;
  uint32_t* const coef1 = coef0 + 8 * c0;
  const long long n_evals = 2LL * ds0 - 2LL * (ds0 >> n_layers);
  if (rank == 0 && t < 4) {
    state[t] = state_in[t];
    root[t] = root_in[t];
  }
  __syncthreads();
  long long e_off = 0, l_off = 0;
  int p_off = 0;
#pragma unroll 1
  for (int layer = 0;; ++layer) {
    const int log_ds = log_ds0 - layer, ds = 1 << log_ds, c = c0 >> layer;
    if (rank == 0) {
      // the draw, by warp 0
      if (t < 32) {
        u64 a = t < 4 ? state[t] : t < 8 ? root[t - 4] : 0;
        if (t == 8) a = 0x01;  // a 64-byte message
        if (t == kRate - 1) a = kPadLast;
        a = keccak_f_warp(a);
        if (t < 4) {
          state[t] = a;
          states[4 * layer + t] = a;
        }
        __syncwarp();
        if (t == 0) {
          uint32_t z[8];
          state_to_zeta(state, z);
#pragma unroll
          for (int k = 0; k < 8; ++k) zeta_sm[k] = z[k];
        }
      }
      __syncthreads();
      if (layer == n_layers) {
        // the final fold: 2 coefficients left
        if (t == 0) {
          const uint32_t* src = n_layers & 1 ? coef0 : coef1;
          uint32_t a[8], b[8], f[8], v[8];
          sm_get(src, c0, 0, a);
          sm_get(src, c0, 1, b);
          fold(a, b, zeta_sm, f);
          from_mont(f, v);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            rows[4 * n_layers + j] = (u64)v[2 * j] | ((u64)v[2 * j + 1] << 32);
        }
        return;
      }
      const uint32_t* src = layer & 1 ? coef0 : coef1;
      uint32_t* dst = layer & 1 ? coef1 : coef0;
      // fold, scale by the offset's powers, scatter to bit-reversed order;
      // zeros past the coefficients
#pragma unroll 1
      for (int i = t; i < ds; i += kTailThreads) {
        uint32_t v[8];
        if (i < c) {
          uint32_t a[8], b[8], f[8], pw[8], zeta[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) zeta[k] = zeta_sm[k];
          if (layer == 0) {
            lcp::load_elem(coeffs, coeff_stride, 2 * i, a);
            lcp::load_elem(coeffs, coeff_stride, 2 * i + 1, b);
          } else {
            sm_get(src, c0, 2 * i, a);
            sm_get(src, c0, 2 * i + 1, b);
          }
          fold(a, b, zeta, f);
          sm_put(dst, c0, i, f);
          load_entry(powers, p_off + i, pw);
          lcp::mont_mul(f, pw, v);
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = 0;
        }
        sm_put(x, plane, phys(rev_bits(i, log_ds)), v);
      }
      __syncthreads();
      // decimation in time: the stage of half-size m pairs j and j + m of
      // each run of 2m, the upper one times w_{2m}^j (one at j = 0)
#pragma unroll 1
      for (int log_m = 0; log_m < log_ds; ++log_m) {
        const int m = 1 << log_m;
#pragma unroll 1
        for (int bf = t; bf < ds / 2; bf += kTailThreads) {
          const int j = bf & (m - 1);
          const int lo = ((bf >> log_m) << (log_m + 1)) | j;
          uint32_t u[8], v[8], s[8], d[8];
          sm_get(x, plane, phys(lo), u);
          sm_get(x, plane, phys(lo + m), v);
          if (j != 0) {
            uint32_t w[8], vw[8];
            load_entry(twiddles, m + j, w);
            lcp::mont_mul(v, w, vw);
#pragma unroll
            for (int k = 0; k < 8; ++k) v[k] = vw[k];
          }
          lcp::add_mod(u, v, s);
          lcp::sub_mod(u, v, d);
          sm_put(x, plane, phys(lo), s);
          sm_put(x, plane, phys(lo + m), d);
        }
        __syncthreads();
      }
#pragma unroll 1
      for (int i = t; i < ds; i += kTailThreads) {
        uint32_t v[8];
        sm_get(x, plane, phys(i), v);
        lcp::store_elem(evals, n_evals, e_off + i, v);
      }
    } else if (layer == n_layers) {
      return;
    }
    cluster.sync();  // the layer's evaluations are out
    // this block's slice of the leaves, and the slice's subtree; a level of
    // s nodes starts at node 2 ds - 2 s of the layer's levels
    const int width = ds > n_ranks ? ds / n_ranks : 1;
    const int first = rank * width;
    if (first < ds) {
      hash_leaves(evals, n_evals, e_off + first, levels + (l_off + first) * 4, width);
      __syncthreads();
#pragma unroll 1
      for (int s = ds, start = first, w = width; w > 1; s >>= 1, start >>= 1, w >>= 1) {
        const long long below = l_off + 2LL * ds - 2LL * s, above = below + s;
        hash_level(levels + (below + start) * 4, levels + (above + start / 2) * 4, w / 2);
        __syncthreads();
      }
    }
    cluster.sync();  // every slice's root is out
    if (rank == 0) {
#pragma unroll 1
      for (int s = ds / width; s > 1; s >>= 1) {
        const long long below = l_off + 2LL * ds - 2LL * s, above = below + s;
        hash_level(levels + below * 4, levels + above * 4, s / 2);
        __syncthreads();
      }
      if (t < 4) {
        root[t] = __ldcg(levels + (l_off + 2LL * ds - 2) * 4 + t);
        rows[4 * layer + t] = root[t];
      }
      __syncthreads();
    }
    e_off += ds;
    l_off += 2 * ds - 1;
    p_off += c;
  }
}

}  // namespace

extern "C" {

// n_layers layers from 2^log_ds0 points down, and the final fold, by one
// cluster of `cluster` blocks (1, 2, 4, 8 or 16): see the layout above.
// Refuses a first layer above 2^kTailMaxLog points, or one with fewer points
// than its 2^n_layers coefficients.
int lcp_fri_tail(const void* coeffs, long long coeff_stride, const void* state,
                 const void* root, const void* powers, const void* twiddles, int n_layers,
                 int log_ds0, int cluster, void* evals, void* levels, void* rows,
                 void* states, void* stream) {
  if (n_layers < 1 || log_ds0 > kTailMaxLog || n_layers > log_ds0 ||
      coeff_stride < (2LL << n_layers) || cluster < 1 || cluster > 16 ||
      (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  const int ds0 = 1 << log_ds0;
  const size_t smem = (size_t)(8 * (ds0 + ds0 / 32) + 16 * (1 << n_layers)) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      fri_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(fri_tail_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused set-up or launch leaves nothing behind
    return (int)err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster, 1, 1);
  config.blockDim = dim3(kTailThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, fri_tail_kernel, (const int32_t*)coeffs, coeff_stride,
                           (const u64*)state, (const u64*)root, (const uint32_t*)powers,
                           (const uint32_t*)twiddles, n_layers, log_ds0, (int32_t*)evals,
                           (u64*)levels, (u64*)rows, (u64*)states);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
