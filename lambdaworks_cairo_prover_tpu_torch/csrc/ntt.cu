// H3 `ntt_dif_stage` and H4 `ntt_dif_local`: the port's NTT.
//
// Together they replace the JAX package's five TPU NTT schedules:
// ntt/fused.py:_gpair_kernel, _gsingle_kernel and _local_kernel_body, and
// field/pallas_mul.py:_butterfly_kernel and _butterfly2_kernel.  All compute
// the same values (evaluate(c)[i] = p(w^i), natural order), so one schedule
// serves: decimation in frequency (natural input, bit-reversed output), the
// stages with half-size m >= 2^LOCAL_LOG as one H3 launch each, then every
// stage with m < 2^LOCAL_LOG in one H4 launch; the caller's bit-reverse
// gather restores natural order.
//
// Data: x is a (16, B, n) int32 limb tensor, contiguous, transformed in
// place along its last axis; `total` = B * n is its limb stride.
// Twiddles: tw is a (16, >= n) table with tw[m + j] = w_{2m}^j for every
// power of two m < n and j < m (entry 0 unused), limb stride tw_ls; a
// stage reads the contiguous run tw[m .. 2m).
//
// Bound on the H100: bytes.  H3 moves 2 x 64 B in and out plus one 64 B
// twiddle per butterfly for one product; its log2(n) - LOCAL_LOG launches
// each stream the whole array.  H4 reads and writes each point once for
// its LOCAL_LOG stages, holding the chunk in shared memory as 8 packed
// 32-bit words per point (32 KB at 2^10 points) laid out word-major, so
// threads on neighbouring butterflies hit neighbouring banks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

#define LOCAL_LOG 10
#define LOCAL_SIZE (1 << LOCAL_LOG)

namespace {

__device__ __forceinline__ void dif_butterfly(uint32_t u[8], uint32_t v[8],
                                              const uint32_t w[8]) {
  uint32_t s[8], d[8];
  lcp::add_mod(u, v, s);
  lcp::sub_mod(u, v, d);
  lcp::mont_mul(d, w, v);
#pragma unroll
  for (int k = 0; k < 8; ++k) u[k] = s[k];
}

// One DIF stage of half-size m = 2^log_m over every column.
__global__ void ntt_dif_stage_kernel(int32_t* x, long long total, int log_n, int log_m,
                                     const int32_t* tw, long long tw_ls) {
  const long long half = total >> 1;
  const long long m = 1LL << log_m;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x; b < half; b += stride) {
    long long col = b >> (log_n - 1);
    long long r = b & ((1LL << (log_n - 1)) - 1);
    long long j = r & (m - 1);
    long long e0 = (col << log_n) + ((r >> log_m) << (log_m + 1)) + j;
    long long e1 = e0 + m;
    uint32_t u[8], v[8], w[8];
    lcp::load_elem(x, total, e0, u);
    lcp::load_elem(x, total, e1, v);
    lcp::load_elem(tw, tw_ls, m + j, w);
    dif_butterfly(u, v, w);
    lcp::store_elem(x, total, e0, u);
    lcp::store_elem(x, total, e1, v);
  }
}

// Every DIF stage with m < chunk = 2^log_chunk on one chunk per block.
__global__ void ntt_dif_local_kernel(int32_t* x, long long total, int log_chunk,
                                     const int32_t* tw, long long tw_ls) {
  __shared__ uint32_t sm[8][LOCAL_SIZE];
  const int chunk = 1 << log_chunk;
  const long long base = (long long)blockIdx.x << log_chunk;
  for (int e = threadIdx.x; e < chunk; e += blockDim.x) {
    uint32_t w[8];
    lcp::load_elem(x, total, base + e, w);
#pragma unroll
    for (int k = 0; k < 8; ++k) sm[k][e] = w[k];
  }
  __syncthreads();
  for (int lm = log_chunk - 1; lm >= 0; --lm) {
    const int m = 1 << lm;
    for (int b = threadIdx.x; b < (chunk >> 1); b += blockDim.x) {
      int j = b & (m - 1);
      int e0 = ((b >> lm) << (lm + 1)) + j;
      int e1 = e0 + m;
      uint32_t u[8], v[8], w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        u[k] = sm[k][e0];
        v[k] = sm[k][e1];
      }
      lcp::load_elem(tw, tw_ls, m + j, w);
      dif_butterfly(u, v, w);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        sm[k][e0] = u[k];
        sm[k][e1] = v[k];
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < chunk; e += blockDim.x) {
    uint32_t w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = sm[k][e];
    lcp::store_elem(x, total, base + e, w);
  }
}

}  // namespace

extern "C" {

int lcp_ntt_dif_stage(void* x, long long total, int log_n, int log_m,
                      const void* tw, long long tw_ls, void* stream) {
  if (total <= 1 || log_n < 1 || log_m < 0 || log_m >= log_n) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = ((total >> 1) + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  ntt_dif_stage_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)x, total, log_n, log_m, (const int32_t*)tw, tw_ls);
  return (int)cudaGetLastError();
}

int lcp_ntt_dif_local(void* x, long long total, int log_chunk,
                      const void* tw, long long tw_ls, void* stream) {
  if (log_chunk < 1 || log_chunk > LOCAL_LOG || total % (1LL << log_chunk) != 0)
    return (int)cudaErrorInvalidValue;
  long long blocks = total >> log_chunk;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  int threads = (1 << log_chunk) >> 1;
  if (threads > 512) threads = 512;
  ntt_dif_local_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)x, total, log_chunk, (const int32_t*)tw, tw_ls);
  return (int)cudaGetLastError();
}

}  // extern "C"
