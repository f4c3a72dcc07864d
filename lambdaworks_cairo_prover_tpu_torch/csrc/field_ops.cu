// H1 `mont_mul` and H2 `add_sub_mod`: elementwise Stark252 kernels.
//
// Replace the TPU kernels field/pallas_mul.py:_mul_kernel (H1) and
// _add_kernel / _sub_kernel (H2) of the JAX package.
//
// Each operand, and the output, is in either layout of field.cuh: (16, ...)
// limbs or (8, ...) packed words.  The resident trace, LDE and domain tables
// are packed and are read as they lie; the caller picks the output's layout
// (packed for the next H1/H2, limbs for a kernel that reads limbs).
//
// Bound on the H100: bytes.  A packed element is 32 B, so a product of two
// packed operands into a packed result moves 3 x 32 B for ~200 integer
// instructions (an add or sub ~40): 0.0601 ms at 2^21 elements at 3.35 TB/s.
// An elementwise kernel bound by bytes gains only from moving fewer bytes in
// full-width accesses, and that is the whole design.  A thread takes 4
// consecutive elements.  A word (or limb) row of an operand whose 4 elements
// lie consecutive and 16-byte aligned is one 16-byte load (LDG.128), and of
// the output one 16-byte store; an element that the 4 share (a scalar, a
// column broadcast over the points) is loaded once; other operands and the
// ragged tail go one element at a time.  No thread reads what another loads,
// so shared memory, TMA and wgmma have no part here.
//
// Broadcasts and views without copies: output element e reads element
// i = (e / X_div) % X_mod of operand X's own batch, which lies at
// (i / X_run) * X_run_stride + i % X_run, limb (word) row k at k * X_ls.
// div/mod cover a scalar (mod 1), a row repeated over leading axes (div 1,
// mod m) and a column repeated over trailing axes (div m, mod g); run and
// run_stride a view cut along its last axis (a chunk of the points of
// several columns).  run == mod: one run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

namespace {

struct Operand {
  const int32_t* ptr;
  long long ls;          // limb (word) row stride, in elements
  long long div, mod;    // the broadcast
  long long run, run_stride;
  int packed;            // 1: (8, ...) words; 0: (16, ...) limbs
  int vec;               // groups of 4 lie consecutive and 16-byte aligned
};

struct Output {
  int32_t* ptr;          // (16 or 8, n), row stride n
  int packed;
  int vec;               // n % 4 == 0 and ptr 16-byte aligned
};

__device__ __forceinline__ long long operand_offset(const Operand& x, long long e) {
  long long i = (x.div == 1) ? e : e / x.div;
  if (i >= x.mod) i %= x.mod;
  return (x.run == x.mod) ? i : (i / x.run) * x.run_stride + i % x.run;
}

__device__ __forceinline__ void load_one(const Operand& x, long long off, uint32_t w[8]) {
  if (x.packed) {
    lcp::load_packed(x.ptr, x.ls, off, w);
  } else {
    lcp::load_elem(x.ptr, x.ls, off, w);
  }
}

// Output elements e0 .. e0 + cnt - 1 (e0 a multiple of 4) of operand x.
__device__ __forceinline__ void load_group(const Operand& x, long long e0, int cnt,
                                           uint32_t w[4][8]) {
  if (cnt == 4 && (x.mod == 1 || (x.div & 3) == 0)) {
    load_one(x, operand_offset(x, e0), w[0]);  // one element for all 4
#pragma unroll
    for (int j = 1; j < 4; ++j) {
#pragma unroll
      for (int k = 0; k < 8; ++k) w[j][k] = w[0][k];
    }
  } else if (cnt == 4 && x.vec) {
    const long long off = operand_offset(x, e0);
    if (x.packed) {
      lcp::load_packed4(x.ptr, x.ls, off, w);
    } else {
      lcp::load_elem4(x.ptr, x.ls, off, w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < cnt) load_one(x, operand_offset(x, e0 + j), w[j]);
    }
  }
}

__device__ __forceinline__ void store_group(const Output& o, long long n, long long e0,
                                            int cnt, const uint32_t w[4][8]) {
  if (cnt == 4 && o.vec) {
    if (o.packed) {
      lcp::store_packed4(o.ptr, n, e0, w);
    } else {
      lcp::store_elem4(o.ptr, n, e0, w);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < cnt) {
      if (o.packed) {
        lcp::store_packed(o.ptr, n, e0 + j, w[j]);
      } else {
        lcp::store_elem(o.ptr, n, e0 + j, w[j]);
      }
    }
  }
}

struct MulOp {
  __device__ __forceinline__ void operator()(const uint32_t a[8], const uint32_t b[8],
                                             uint32_t r[8]) const {
    lcp::mont_mul(a, b, r);
  }
};

struct AddOp {
  __device__ __forceinline__ void operator()(const uint32_t a[8], const uint32_t b[8],
                                             uint32_t r[8]) const {
    lcp::add_mod(a, b, r);
  }
};

struct SubOp {
  __device__ __forceinline__ void operator()(const uint32_t a[8], const uint32_t b[8],
                                             uint32_t r[8]) const {
    lcp::sub_mod(a, b, r);
  }
};

// Each thread a group of 4 output elements (grid-stride over the groups).
// The result overwrites the first operand's registers: every op reads all
// of a before it writes r.
template <typename Op>
__device__ __forceinline__ void binop_groups(const Operand& a, const Operand& b,
                                             const Output& out, long long n, Op op) {
  const long long groups = (n + 3) >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const long long e0 = g << 2;
    const int cnt = (n - e0 < 4) ? (int)(n - e0) : 4;
    uint32_t x[4][8], y[4][8];
    load_group(a, e0, cnt, x);
    load_group(b, e0, cnt, y);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < cnt) op(x[j], y[j], x[j]);
    }
    store_group(out, n, e0, cnt, x);
  }
}

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    mont_mul_kernel(Operand a, Operand b, Output out, long long n) {
  binop_groups(a, b, out, n, MulOp{});
}

__global__ void __launch_bounds__(kThreads)
    add_sub_kernel(int op, Operand a, Operand b, Output out, long long n) {
  if (op == 0) {
    binop_groups(a, b, out, n, AddOp{});
  } else {
    binop_groups(a, b, out, n, SubOp{});
  }
}

unsigned int grid_for(long long n) {
  long long blocks = ((n + 3) / 4 + kThreads - 1) / kThreads;
  const long long cap = 1LL << 20;  // the grid-stride loop covers the rest
  return (unsigned int)(blocks < cap ? blocks : cap);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// The conditions under which a group of 4 output elements (from a multiple
// of 4) reads 4 consecutive elements of x at a 16-byte aligned address.
Operand make_operand(const void* ptr, long long ls, long long div, long long mod,
                     long long run, long long run_stride, int packed) {
  const bool vec = div == 1 && mod % 4 == 0 && run % 4 == 0 &&
                   (run == mod || run_stride % 4 == 0) && ls % 4 == 0 && aligned16(ptr);
  return Operand{(const int32_t*)ptr, ls, div, mod, run, run_stride, packed ? 1 : 0,
                 vec ? 1 : 0};
}

Output make_output(void* ptr, int packed, long long n) {
  return Output{(int32_t*)ptr, packed ? 1 : 0, (n % 4 == 0 && aligned16(ptr)) ? 1 : 0};
}

}  // namespace

extern "C" {

// Each operand: pointer, row stride, div, mod, run, run stride, packed.
int lcp_mont_mul(const void* a, long long a_ls, long long a_div, long long a_mod,
                 long long a_run, long long a_run_stride, int a_packed,
                 const void* b, long long b_ls, long long b_div, long long b_mod,
                 long long b_run, long long b_run_stride, int b_packed,
                 void* out, int out_packed, long long n, void* stream) {
  if (n <= 0) return 0;
  mont_mul_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      make_operand(a, a_ls, a_div, a_mod, a_run, a_run_stride, a_packed),
      make_operand(b, b_ls, b_div, b_mod, b_run, b_run_stride, b_packed),
      make_output(out, out_packed, n), n);
  return (int)cudaGetLastError();
}

// op 0: a + b, op 1: a - b (mod p)
int lcp_add_sub(int op, const void* a, long long a_ls, long long a_div, long long a_mod,
                long long a_run, long long a_run_stride, int a_packed,
                const void* b, long long b_ls, long long b_div, long long b_mod,
                long long b_run, long long b_run_stride, int b_packed,
                void* out, int out_packed, long long n, void* stream) {
  if (n <= 0) return 0;
  add_sub_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      op, make_operand(a, a_ls, a_div, a_mod, a_run, a_run_stride, a_packed),
      make_operand(b, b_ls, b_div, b_mod, b_run, b_run_stride, b_packed),
      make_output(out, out_packed, n), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
