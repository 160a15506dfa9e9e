// BabyBear (p = 2^31 - 2^27 + 1) and its quintic extension F_p[x]/(x^5 - 2)
// on 32-bit words, in Montgomery form (x·R mod p, R = 2^32).
//
// Every function here is __host__ __device__ under nvcc and plain inline
// C++ under g++, so the CPU tests compile this same arithmetic into a host
// library and hold it against the JAX package's words.  csrc/field.cu puts
// a grid around it.
//
// Counterpart of valida_tpu/field/babybear.py's _mul64, _umulh_p and
// _monty_reduce, which build the 64-bit product from 16-bit limbs because
// the TPU has no 32x32->64 multiply.  Hopper has one (IMAD.WIDE), so a
// Montgomery product is the 64-bit product and one reduction with
// mu = p^-1 mod 2^32: three multiplies, a subtract and a conditional add.
//
// The `apply_*` functions take raw int32 words as the PyTorch plain versions
// (valida_tpu_torch/field) do, and compute their function on every word:
// an operand is first taken mod p as a signed 32-bit value (`canon`), so a
// word >= p or a negative bit pattern gives what the int64 plain code
// gives.  from_wrapped_u32 reads its word as unsigned.

#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define BB_FN __host__ __device__ __forceinline__
#define BB_UNROLL _Pragma("unroll")
#else
#define BB_FN static inline
#define BB_UNROLL
#endif

namespace bbf {

constexpr uint32_t P = 2013265921u;          // 2^31 - 2^27 + 1
constexpr uint32_t MONTY_MU = 2281701377u;   // p^-1 mod 2^32
constexpr uint32_t R1 = 268435454u;          // 2^32 mod p: one, Montgomery
constexpr uint32_t R2 = 1172168163u;         // 2^64 mod p
constexpr uint64_t P_SHIFTED = (uint64_t)P << 32;
constexpr int D = 5;                         // extension degree; x^5 = W = 2

// the element-wise operations of csrc/field.cu's field_elementwise (K1);
// valida_tpu_torch/field/babybear.py OPS lists the same codes
enum Op : int {
  OP_MUL = 0, OP_ADD = 1, OP_SUB = 2, OP_NEG = 3, OP_TO_MONTY = 4,
  OP_FROM_MONTY = 5, OP_FROM_WRAPPED_U32 = 6, N_OPS = 7
};

// x·2^-32 mod p in [0, p), for x < p·2^32
BB_FN uint32_t monty_reduce(uint64_t x) {
  const uint32_t t = (uint32_t)x * MONTY_MU;   // x·mu mod 2^32
  const uint64_t u = (uint64_t)t * P;          // u = x mod 2^32
  const uint32_t hi = (uint32_t)((x - u) >> 32);
  return x < u ? hi + P : hi;
}

// a signed 32-bit word mod p, in [0, p)
BB_FN uint32_t canon(int32_t v) {
  // v + 2p lies in [0, 2^32) for v < 0, and v < 2p for v >= 0
  const uint32_t u = v < 0 ? (uint32_t)v + 2u * P : (uint32_t)v;
  return u >= P ? u - P : u;
}

// canonical operands in [0, p) -> canonical result
BB_FN uint32_t mul(uint32_t a, uint32_t b) {
  return monty_reduce((uint64_t)a * b);
}
BB_FN uint32_t add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return s >= P ? s - P : s;
}
BB_FN uint32_t sub(uint32_t a, uint32_t b) {
  const uint32_t d = a - b;
  return a < b ? d + P : d;
}
BB_FN uint32_t neg(uint32_t a) { return a ? P - a : 0u; }
BB_FN uint32_t to_monty(uint32_t a) { return mul(a, R2); }
BB_FN uint32_t from_monty(uint32_t a) { return monty_reduce(a); }
// any u32 x -> the Montgomery form of x mod p: x·R2 < 2^32·p
BB_FN uint32_t from_wrapped_u32(uint32_t x) {
  return monty_reduce((uint64_t)x * R2);
}

// W^(i (p-1)/5) in Montgomery form, i mod 5: x -> x^p scales coefficient i
// by it (valida_tpu_torch/field/ext.py _FROB_COEFFS_MONTY; a CPU test holds
// them).  A switch, not an array: device code may not index a host array.
BB_FN uint32_t frob(int i) {
  switch (i % D) {
    case 0: return R1;
    case 1: return 1079828539u;
    case 2: return 847078768u;
    case 3: return 1597816133u;
    default: return 233372948u;
  }
}

BB_FN uint32_t sqn(uint32_t a, int n) {
  for (int i = 0; i < n; ++i) a = mul(a, a);
  return a;
}

// a^(p-2), p - 2 = 7·2^28 + 2^27 - 1 (0 -> 0), by an addition chain of 29
// squarings and 10 products (square and multiply takes 30 and 29):
// o_k = a^(2^k - 1) for k = 1, 2, 3, 6, 12, 24, 27; t = (o27·a)^2 = a^(2^28);
// a^(p-2) = t^7 · o27
BB_FN uint32_t inv(uint32_t a) {
  const uint32_t o2 = mul(sqn(a, 1), a);
  const uint32_t o3 = mul(sqn(o2, 1), a);
  const uint32_t o6 = mul(sqn(o3, 3), o3);
  const uint32_t o12 = mul(sqn(o6, 6), o6);
  const uint32_t o24 = mul(sqn(o12, 12), o12);
  const uint32_t o27 = mul(sqn(o24, 3), o3);
  const uint32_t t = sqn(mul(o27, a), 1);
  const uint32_t t3 = mul(sqn(t, 1), t);
  const uint32_t t7 = mul(sqn(t3, 1), t);
  return mul(t7, o27);
}

// s < 2^64 -> s or s - p·2^32, below p·2^32 when s < 2·p·2^32
BB_FN uint64_t fold(uint64_t s) {
  return s >= P_SHIFTED ? s - P_SHIFTED : s;
}

// coefficient k of a·b mod x^5 - 2 (canonical coefficients): the five
// products a_i b_(k-i mod 5), b doubled where the exponent wrapped (b2), each
// below p^2, summed in 64 bits with the sum kept below p·2^32, then one
// reduction (4 p^2 < 2^64)
BB_FN uint32_t ext_mul_coeff(const uint32_t a[D], const uint32_t b[D],
                             const uint32_t b2[D], int k) {
  uint64_t s = 0;
  BB_UNROLL
  for (int i = 0; i < 4; ++i) {
    const int j = (k - i + D) % D;
    s += (uint64_t)a[i] * (i > k ? b2[j] : b[j]);
  }
  const int j = (k - 4 + D) % D;
  s = fold(s) + (uint64_t)a[4] * (4 > k ? b2[j] : b[j]);
  return monty_reduce(fold(s));
}

BB_FN void ext_mul(const uint32_t a[D], const uint32_t b[D], uint32_t c[D]) {
  uint32_t b2[D];
  BB_UNROLL
  for (int i = 0; i < D; ++i) b2[i] = add(b[i], b[i]);
  BB_UNROLL
  for (int k = 0; k < D; ++k) c[k] = ext_mul_coeff(a, b, b2, k);
}

// the k-th Frobenius map, x -> x^(p^k): coefficient i scaled by frob(i·k);
// coefficient 0 is kept, frob(0) being one
BB_FN void frobenius(const uint32_t a[D], int k, uint32_t out[D]) {
  out[0] = a[0];
  BB_UNROLL
  for (int i = 1; i < D; ++i) out[i] = mul(a[i], frob(i * k));
}

// a^-1 = r / norm(a) with r = a^(p + p^2 + p^3 + p^4), the norm a·r in the
// base field; 0 -> 0.  r takes two extension products by the Frobenius
// maps: t = a^p · a^(p^2), then r = t · t^(p^2).  Only coefficient 0 of
// a·r is formed.
BB_FN void ext_inv(const uint32_t a[D], uint32_t out[D]) {
  uint32_t f1[D], f2[D], t[D], r[D];
  frobenius(a, 1, f1);
  frobenius(a, 2, f2);
  ext_mul(f1, f2, t);
  frobenius(t, 2, f2);
  ext_mul(t, f2, r);
  uint32_t r2[D];
  BB_UNROLL
  for (int i = 0; i < D; ++i) r2[i] = add(r[i], r[i]);
  const uint32_t norm_inv = inv(ext_mul_coeff(a, r, r2, 0));
  BB_UNROLL
  for (int i = 0; i < D; ++i) out[i] = mul(r[i], norm_inv);
}

// ---------------------------------------------------------------------------
// One output word or element from raw int32 operand words, as the kernels
// and the host harness of the CPU tests apply them
// ---------------------------------------------------------------------------

template <int OP>
BB_FN uint32_t apply_elementwise(int32_t x, int32_t y) {
  if (OP == OP_FROM_WRAPPED_U32) return from_wrapped_u32((uint32_t)x);
  const uint32_t a = canon(x);
  switch (OP) {
    case OP_MUL: return mul(a, canon(y));
    case OP_ADD: return add(a, canon(y));
    case OP_SUB: return sub(a, canon(y));
    case OP_NEG: return neg(a);
    case OP_TO_MONTY: return to_monty(a);
    default: return from_monty(a);
  }
}

// one extension element: coefficient i of an operand at p[i·stride]
BB_FN void load_ext(const int32_t* p, int64_t stride, uint32_t out[D]) {
  BB_UNROLL
  for (int i = 0; i < D; ++i) out[i] = canon(p[i * stride]);
}

BB_FN void apply_ext_mul(const int32_t* a, int64_t a_coef, const int32_t* b,
                         int64_t b_coef, int32_t* out) {
  uint32_t x[D], y[D], c[D];
  load_ext(a, a_coef, x);
  load_ext(b, b_coef, y);
  ext_mul(x, y, c);
  BB_UNROLL
  for (int i = 0; i < D; ++i) out[i] = (int32_t)c[i];
}

BB_FN int32_t apply_inv(int32_t x) { return (int32_t)inv(canon(x)); }

BB_FN void apply_ext_inv(const int32_t* a, int64_t a_coef, int32_t* out) {
  uint32_t x[D], c[D];
  load_ext(a, a_coef, x);
  ext_inv(x, c);
  BB_UNROLL
  for (int i = 0; i < D; ++i) out[i] = (int32_t)c[i];
}

}  // namespace bbf
