// H1 `mont_mul` and H2 `add_sub_mod`: elementwise Stark252 kernels.
//
// Replace the TPU kernels field/pallas_mul.py:_mul_kernel (H1) and
// _add_kernel / _sub_kernel (H2) of the JAX package.
//
// Bound on the H100: bytes.  An element is 64 B in the (16, ...) int32 limb
// layout, so a product reads 2 x 64 B and writes 64 B for ~200 integer
// instructions; add/sub do ~40.  One thread per element, neighbouring threads
// on neighbouring elements, so each limb row is read coalesced.  The
// (16, ...) layout carries 2x the bytes of a packed (8, ...) layout; packing
// is later work.
//
// Broadcasting without copies: an operand X is read at element
// (e / X_div) % X_mod of its own batch, with limb stride X_ls.  That covers a
// scalar (div 1, mod 1), a row repeated over leading axes (div 1, mod m) and
// a column repeated over trailing axes (div m, mod g).
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

namespace {

struct Operand {
  const int32_t* ptr;
  long long ls;   // limb stride in elements
  long long div;
  long long mod;
};

__device__ __forceinline__ long long operand_index(const Operand& x, long long e) {
  return (x.mod == 1) ? 0 : ((x.div == 1 ? e : e / x.div) % x.mod);
}

__global__ void mont_mul_kernel(Operand a, Operand b, int32_t* out, long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n; e += stride) {
    uint32_t x[8], y[8], r[8];
    lcp::load_elem(a.ptr, a.ls, operand_index(a, e), x);
    lcp::load_elem(b.ptr, b.ls, operand_index(b, e), y);
    lcp::mont_mul(x, y, r);
    lcp::store_elem(out, n, e, r);
  }
}

__global__ void add_sub_kernel(int op, Operand a, Operand b, int32_t* out, long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n; e += stride) {
    uint32_t x[8], y[8], r[8];
    lcp::load_elem(a.ptr, a.ls, operand_index(a, e), x);
    lcp::load_elem(b.ptr, b.ls, operand_index(b, e), y);
    if (op == 0) {
      lcp::add_mod(x, y, r);
    } else {
      lcp::sub_mod(x, y, r);
    }
    lcp::store_elem(out, n, e, r);
  }
}

constexpr int kThreads = 256;

unsigned int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 1LL << 20;  // grid-stride loop covers the rest
  return (unsigned int)(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" {

int lcp_mont_mul(const void* a, long long a_ls, long long a_div, long long a_mod,
                 const void* b, long long b_ls, long long b_div, long long b_mod,
                 void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  Operand x{(const int32_t*)a, a_ls, a_div, a_mod};
  Operand y{(const int32_t*)b, b_ls, b_div, b_mod};
  mont_mul_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      x, y, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

// op 0: a + b, op 1: a - b (mod p)
int lcp_add_sub(int op, const void* a, long long a_ls, long long a_div, long long a_mod,
                const void* b, long long b_ls, long long b_div, long long b_mod,
                void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  Operand x{(const int32_t*)a, a_ls, a_div, a_mod};
  Operand y{(const int32_t*)b, b_ls, b_div, b_mod};
  add_sub_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      op, x, y, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
