// Stark252 field arithmetic for the port's CUDA kernels.
//
// p = 2^251 + 17*2^192 + 1.  Elements are in Montgomery form (R = 2^256) and
// canonical (< p).  In memory an operand is in one of the JAX package's two
// layouts, both on the leading axis:
//   limbs  (16, ...): 16 little-endian 16-bit limbs, one int32 word per limb
//          (values < 2^16), limb k of element e at base[k * limb_stride + e]
//          (load_elem / store_elem);
//   packed (8, ...): 8 little-endian 32-bit words, limb 2k in the low half of
//          word k and limb 2k+1 in the high half (the uint32 bit pattern in
//          an int32), word k of element e at base[k * word_stride + e]
//          (load_packed / store_packed), half the bytes.
// The *4 helpers move four consecutive elements, each row of the layout one
// 16-byte access (idx and the stride multiples of 4, base 16-byte aligned).
// In registers an element is 8 little-endian 32-bit words.
//
// In 32-bit words p = [1, 0, 0, 0, 0, 0, 17, 2^27], and p = 1 (mod 2^32), so
// -p^-1 mod 2^32 = 0xFFFFFFFF and each CIOS reduction factor is m = -t0.
#pragma once

#include <stdint.h>

namespace lcp {

__device__ __forceinline__ void load_elem(const int32_t* base, long long limb_stride,
                                          long long idx, uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t lo = (uint32_t)base[(2 * k) * limb_stride + idx];
    uint32_t hi = (uint32_t)base[(2 * k + 1) * limb_stride + idx];
    w[k] = (lo & 0xFFFFu) | (hi << 16);
  }
}

__device__ __forceinline__ void store_elem(int32_t* base, long long limb_stride,
                                           long long idx, const uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    base[(2 * k) * limb_stride + idx] = (int32_t)(w[k] & 0xFFFFu);
    base[(2 * k + 1) * limb_stride + idx] = (int32_t)(w[k] >> 16);
  }
}

__device__ __forceinline__ void load_packed(const int32_t* base, long long word_stride,
                                            long long idx, uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = (uint32_t)base[k * word_stride + idx];
}

__device__ __forceinline__ void store_packed(int32_t* base, long long word_stride,
                                             long long idx, const uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) base[k * word_stride + idx] = (int32_t)w[k];
}

__device__ __forceinline__ void load_elem4(const int32_t* base, long long limb_stride,
                                           long long idx, uint32_t w[4][8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int4 lo = *reinterpret_cast<const int4*>(base + (2 * k) * limb_stride + idx);
    const int4 hi = *reinterpret_cast<const int4*>(base + (2 * k + 1) * limb_stride + idx);
    w[0][k] = ((uint32_t)lo.x & 0xFFFFu) | ((uint32_t)hi.x << 16);
    w[1][k] = ((uint32_t)lo.y & 0xFFFFu) | ((uint32_t)hi.y << 16);
    w[2][k] = ((uint32_t)lo.z & 0xFFFFu) | ((uint32_t)hi.z << 16);
    w[3][k] = ((uint32_t)lo.w & 0xFFFFu) | ((uint32_t)hi.w << 16);
  }
}

__device__ __forceinline__ void store_elem4(int32_t* base, long long limb_stride,
                                            long long idx, const uint32_t w[4][8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    *reinterpret_cast<int4*>(base + (2 * k) * limb_stride + idx) =
        make_int4((int)(w[0][k] & 0xFFFFu), (int)(w[1][k] & 0xFFFFu),
                  (int)(w[2][k] & 0xFFFFu), (int)(w[3][k] & 0xFFFFu));
    *reinterpret_cast<int4*>(base + (2 * k + 1) * limb_stride + idx) =
        make_int4((int)(w[0][k] >> 16), (int)(w[1][k] >> 16), (int)(w[2][k] >> 16),
                  (int)(w[3][k] >> 16));
  }
}

__device__ __forceinline__ void load_packed4(const int32_t* base, long long word_stride,
                                             long long idx, uint32_t w[4][8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int4 v = *reinterpret_cast<const int4*>(base + k * word_stride + idx);
    w[0][k] = (uint32_t)v.x;
    w[1][k] = (uint32_t)v.y;
    w[2][k] = (uint32_t)v.z;
    w[3][k] = (uint32_t)v.w;
  }
}

__device__ __forceinline__ void store_packed4(int32_t* base, long long word_stride,
                                              long long idx, const uint32_t w[4][8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    *reinterpret_cast<int4*>(base + k * word_stride + idx) =
        make_int4((int)w[0][k], (int)w[1][k], (int)w[2][k], (int)w[3][k]);
  }
}

// The multi-word arithmetic below is inline PTX: carry chains of add.cc /
// addc and mad.lo.cc / madc.hi.cc, which the assembler turns into IADD3.X
// and (for a lo/hi pair on neighbouring words) one IMAD.WIDE with carry.  The
// compiler's code for uint64_t carries took some 590 instructions a
// butterfly; every kernel that is bound by operations pays for each of them.

// a <- a - p when a >= p (a < 2^256).
__device__ __forceinline__ void cond_sub_p(uint32_t a[8]) {
  uint32_t d[8], borrow;
  asm volatile(
      "sub.cc.u32 %0, %9, 1;\n\t"
      "subc.cc.u32 %1, %10, 0;\n\t"
      "subc.cc.u32 %2, %11, 0;\n\t"
      "subc.cc.u32 %3, %12, 0;\n\t"
      "subc.cc.u32 %4, %13, 0;\n\t"
      "subc.cc.u32 %5, %14, 0;\n\t"
      "subc.cc.u32 %6, %15, 17;\n\t"
      "subc.cc.u32 %7, %16, 0x8000000;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=&r"(d[0]), "=&r"(d[1]), "=&r"(d[2]), "=&r"(d[3]), "=&r"(d[4]), "=&r"(d[5]),
        "=&r"(d[6]), "=&r"(d[7]), "=&r"(borrow)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]));
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = borrow ? a[k] : d[k];
}

// r = (a + b) mod p.  a + b < 2p < 2^253, so no carry leaves word 7.
__device__ __forceinline__ void add_mod(const uint32_t a[8], const uint32_t b[8],
                                        uint32_t r[8]) {
  uint32_t t[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) t[k] = a[k];
  asm volatile(
      "add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, %15;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7])
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]),
        "r"(b[7]));
  cond_sub_p(t);
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = t[k];
}

// r = (a - b) mod p: a - b, then + p where the subtraction borrowed.
__device__ __forceinline__ void sub_mod(const uint32_t a[8], const uint32_t b[8],
                                        uint32_t r[8]) {
  uint32_t t[8], mask;
#pragma unroll
  for (int k = 0; k < 8; ++k) t[k] = a[k];
  asm volatile(
      "sub.cc.u32 %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, %10;\n\t"
      "subc.cc.u32 %2, %2, %11;\n\t"
      "subc.cc.u32 %3, %3, %12;\n\t"
      "subc.cc.u32 %4, %4, %13;\n\t"
      "subc.cc.u32 %5, %5, %14;\n\t"
      "subc.cc.u32 %6, %6, %15;\n\t"
      "subc.cc.u32 %7, %7, %16;\n\t"
      "subc.u32 %8, 0, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "=&r"(mask)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]),
        "r"(b[7]));
  const uint32_t p0 = mask & 1u, p6 = mask & 17u, p7 = mask & (1u << 27);
  asm volatile(
      "add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, %9;\n\t"
      "addc.u32 %7, %7, %10;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7])
      : "r"(p0), "r"(p6), "r"(p7));
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = t[k];
}

// One row of the Montgomery product: T <- (T + a * bi + m * p) / 2^32 with
// m = -T mod 2^32.  T is kept as the sum of two accumulators, E[0..7] +
// O[0..7], plus a carry into word 0 that is pending when the word `xp`
// dropped by the row before was not zero.  The products of the even words of
// a land on word pairs (0,1) .. (6,7) and go to E in one carry chain; those
// of the odd words land on (1,2) .. (7,8) and go to O in another, so neither
// chain waits for the other and each lo/hi pair is one wide multiply-add.
// O[0] is folded into E[0] first, and its carry opens O's chain.  m * p =
// m + 17 m 2^192 + m 2^251 goes to E; the sum's word 0 is zero by
// construction and is dropped by the caller, who moves both windows up by
// one word and swaps the roles of the accumulators (a pair that starts on
// word 1 of this row starts on word 0 of the next).  E[8] and O[8] are new
// words of this row.
__device__ __forceinline__ void mont_row(uint32_t* E, uint32_t* O, const uint32_t a[8],
                                         uint32_t bi, uint32_t xp) {
  asm volatile(
      "{\n\t"
      ".reg .u32 m, t;\n\t"
      "add.cc.u32 t, %27, 0xffffffff;\n\t"
      "addc.cc.u32 %0, %0, %17;\n\t"
      "madc.lo.cc.u32 %9, %19, %26, %9;\n\t"
      "madc.hi.cc.u32 %10, %19, %26, %10;\n\t"
      "madc.lo.cc.u32 %11, %21, %26, %11;\n\t"
      "madc.hi.cc.u32 %12, %21, %26, %12;\n\t"
      "madc.lo.cc.u32 %13, %23, %26, %13;\n\t"
      "madc.hi.cc.u32 %14, %23, %26, %14;\n\t"
      "madc.lo.cc.u32 %15, %25, %26, %15;\n\t"
      "madc.hi.u32 %16, %25, %26, 0;\n\t"
      "mad.lo.cc.u32 %0, %18, %26, %0;\n\t"
      "madc.hi.cc.u32 %1, %18, %26, %1;\n\t"
      "madc.lo.cc.u32 %2, %20, %26, %2;\n\t"
      "madc.hi.cc.u32 %3, %20, %26, %3;\n\t"
      "madc.lo.cc.u32 %4, %22, %26, %4;\n\t"
      "madc.hi.cc.u32 %5, %22, %26, %5;\n\t"
      "madc.lo.cc.u32 %6, %24, %26, %6;\n\t"
      "madc.hi.cc.u32 %7, %24, %26, %7;\n\t"
      "addc.u32 %8, 0, 0;\n\t"
      "sub.u32 m, 0, %0;\n\t"
      "mad.lo.cc.u32 %6, m, 17, %6;\n\t"
      "madc.hi.cc.u32 %7, m, 17, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.lo.cc.u32 %7, m, 0x8000000, %7;\n\t"
      "madc.hi.u32 %8, m, 0x8000000, %8;\n\t"
      "}"
      : "+r"(E[0]), "+r"(E[1]), "+r"(E[2]), "+r"(E[3]), "+r"(E[4]), "+r"(E[5]), "+r"(E[6]),
        "+r"(E[7]), "=&r"(E[8]), "+r"(O[1]), "+r"(O[2]), "+r"(O[3]), "+r"(O[4]), "+r"(O[5]),
        "+r"(O[6]), "+r"(O[7]), "=&r"(O[8])
      : "r"(O[0]), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(bi), "r"(xp));
}

// The first row: T = 0, so the products are not added to anything and no
// carry runs between them.
__device__ __forceinline__ void mont_row0(uint32_t* E, uint32_t* O, const uint32_t a[8],
                                          uint32_t bi) {
  asm volatile(
      "{\n\t"
      ".reg .u32 m;\n\t"
      "mul.lo.u32 %9, %18, %25;\n\t"
      "mul.hi.u32 %10, %18, %25;\n\t"
      "mul.lo.u32 %11, %20, %25;\n\t"
      "mul.hi.u32 %12, %20, %25;\n\t"
      "mul.lo.u32 %13, %22, %25;\n\t"
      "mul.hi.u32 %14, %22, %25;\n\t"
      "mul.lo.u32 %15, %24, %25;\n\t"
      "mul.hi.u32 %16, %24, %25;\n\t"
      "mul.lo.u32 %0, %17, %25;\n\t"
      "mul.hi.u32 %1, %17, %25;\n\t"
      "mul.lo.u32 %2, %19, %25;\n\t"
      "mul.hi.u32 %3, %19, %25;\n\t"
      "mul.lo.u32 %4, %21, %25;\n\t"
      "mul.hi.u32 %5, %21, %25;\n\t"
      "mul.lo.u32 %6, %23, %25;\n\t"
      "mul.hi.u32 %7, %23, %25;\n\t"
      "sub.u32 m, 0, %0;\n\t"
      "mad.lo.cc.u32 %6, m, 17, %6;\n\t"
      "madc.hi.cc.u32 %7, m, 17, %7;\n\t"
      "addc.u32 %8, 0, 0;\n\t"
      "mad.lo.cc.u32 %7, m, 0x8000000, %7;\n\t"
      "madc.hi.u32 %8, m, 0x8000000, %8;\n\t"
      "}"
      : "=&r"(E[0]), "=&r"(E[1]), "=&r"(E[2]), "=&r"(E[3]), "=&r"(E[4]), "=&r"(E[5]),
        "=&r"(E[6]), "=&r"(E[7]), "=&r"(E[8]), "=&r"(O[1]), "=&r"(O[2]), "=&r"(O[3]),
        "=&r"(O[4]), "=&r"(O[5]), "=&r"(O[6]), "=&r"(O[7]), "=&r"(O[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(bi));
}

// r = a * b * 2^-256 mod p (word-serial Montgomery product, 32-bit words).
__device__ __forceinline__ void mont_mul(const uint32_t a[8], const uint32_t b[8],
                                         uint32_t r[8]) {
  // word k of row i's window is A[i + k], B[i + k]
  uint32_t A[16], B[16];
  mont_row0(A, B, a, b[0]);
  uint32_t xp = A[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    if (i % 2 == 0) {
      mont_row(A + i, B + i, a, b[i], xp);
      xp = A[i];
    } else {
      mont_row(B + i, A + i, a, b[i], xp);
      xp = B[i];
    }
  }
  // T = A[8..] + B[8..] + the pending carry; T < 2p < 2^253
  uint32_t t[8];
  asm volatile(
      "{\n\t"
      ".reg .u32 t;\n\t"
      "add.cc.u32 t, %24, 0xffffffff;\n\t"
      "addc.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;\n\t"
      "}"
      : "=&r"(t[0]), "=&r"(t[1]), "=&r"(t[2]), "=&r"(t[3]), "=&r"(t[4]), "=&r"(t[5]),
        "=&r"(t[6]), "=&r"(t[7])
      : "r"(A[8]), "r"(A[9]), "r"(A[10]), "r"(A[11]), "r"(A[12]), "r"(A[13]), "r"(A[14]),
        "r"(A[15]), "r"(B[8]), "r"(B[9]), "r"(B[10]), "r"(B[11]), "r"(B[12]), "r"(B[13]),
        "r"(B[14]), "r"(B[15]), "r"(xp));
  cond_sub_p(t);
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = t[k];
}

}  // namespace lcp
