// The row interpreter of a chip's constraint program (csrc/constraint.cu):
// one quotient row's folded constraints, on field.cuh's arithmetic.
//
// Every function here is __host__ __device__ under nvcc and plain inline
// C++ under g++, so the CPU tests compile the same interpreter into a host
// library (with `eval_host`, the whole launch's function on the host) and
// hold it against the port's plain path and the JAX package's words.
//
// A program (valida_tpu_torch/air/program.py) is an int32 array [n, 4] of
// (code, dst, a, b); code packs
//   bits 0-3 the operation (`COp`), bit 4 / 5 whether operand a / b is an
//   extension element (5 words; else one base word), bit 6 whether dst is
//   a uniform word (else a row slot), bits 8-11 / 12-15 the operand kinds
//   (`Kind`).
// The first n_uniform instructions are the uniform program: the inputs
// (challenges, alpha, the cumulative sum, canonical words converted to
// Montgomery form) and every operation on them, run once per block into
// the block-wide array `uni`.  The rest is the row program: operations on
// row values, whose results go to slots, and ACC, which adds a constraint
// (a) times its power of alpha (b) to five 64-bit accumulators.  An
// operand is read where it lies: a slot, a uniform word, a column of the
// row or of its successor (main, preprocessed; a permutation column is an
// extension element of 5 words), a selector of the row, or the immediate
// word in the instruction.  A base operand of an operation with an
// extension operand is promoted, as the port's `VVal` promotes it.
//
// Every column word is taken mod p as a signed word on reading (`canon`),
// so the interpreter computes the plain path's function on any int32
// word.  The accumulators hold sums of products of canonical words below
// p·2^32 (`fold` after each product, each below p^2), and one Montgomery
// reduction of each gives sum_i c_i·alpha^(K-1-i) in Montgomery form: a
// reduction is linear mod p.

#pragma once

#include <stdint.h>

#include "field.cuh"

namespace cst {

using bbf::D;

enum COp : int { OP_ADD = 0, OP_SUB = 1, OP_MUL = 2, OP_NEG = 3, OP_ACC = 4,
                 OP_LOAD = 5 };
enum Kind : int { K_SLOT = 0, K_UNI = 1, K_MAIN_L = 2, K_MAIN_N = 3,
                  K_PREP_L = 4, K_PREP_N = 5, K_PERM_L = 6, K_PERM_N = 7,
                  K_SEL = 8, K_INPUT = 9, K_IMM = 10 };

// the launch's parameters, a host array of int64 in this order
// (valida_tpu_torch/air/quotient.py `_PARAMS`)
enum Param : int {
  P_ROWS = 0,      // R: quotient rows evaluated
  P_LQ,            // logical rows of the buffers (a row's successor wraps)
  P_STRIDE,        // buffer rows a logical row steps over
  P_LOG_L,         // bits of the bit reversal of the buffer's rows; -1: none
  P_QD,            // log2 of the successor's distance and zinv's period
  P_W_MAIN, P_W_PREP, P_W_PERM,     // columns (words) of the buffers
  P_N_UNIFORM, P_N_ROW,             // instructions of the two programs
  P_UNI_WORDS, P_SLOT_WORDS,        // the uniform array and the slots
  N_PARAMS
};

// what the entry refuses, as its (negative) return code
// (valida_tpu_torch/_build.py REFUSALS)
enum Refusal : int { E_PARAMS = -1, E_SMEM = -2 };

// a block's shared memory on sm_90, in bytes
constexpr int64_t SMEM_MAX = 232448;

BB_FN int64_t odd_pitch(int64_t w) { return w ? (w | 1) : 0; }

// shared memory words of a block of T rows (threads): the uniform array,
// the staged rows (the T rows and the 2^qd after them, each at an odd
// pitch) and the slots [slot][thread]
BB_FN int64_t smem_words(const int64_t* p, int64_t T) {
  const int64_t h = (int64_t)1 << p[P_QD];
  return p[P_UNI_WORDS]
         + (T + h) * (odd_pitch(p[P_W_MAIN]) + odd_pitch(p[P_W_PREP])
                      + odd_pitch(p[P_W_PERM]))
         + p[P_SLOT_WORDS] * T;
}

// the rows (threads) of a block: the most of 128, 64 and 32 whose shared
// memory fits; or a refusal
BB_FN int64_t block_rows(const int64_t* p, bool has_prep) {
  if (p[P_QD] < 0 || p[P_QD] > 10 || p[P_LQ] <= 0 || p[P_ROWS] < 0
      || (!has_prep && p[P_W_PREP]))
    return E_PARAMS;
  for (int64_t T = 128; T >= 32; T /= 2)
    if (4 * smem_words(p, T) <= SMEM_MAX) return T;
  return E_SMEM;
}

// logical row j of a buffer -> its row in memory: j·stride, bit-reversed
// over log_l bits for a bit-reversed buffer
BB_FN int64_t buffer_row(int64_t j, const int64_t* p) {
  const uint64_t r = (uint64_t)j * (uint64_t)p[P_STRIDE];
  const int bits = (int)p[P_LOG_L];
  if (bits <= 0) return (int64_t)r;
#if defined(__CUDA_ARCH__)
  return (int64_t)(__brev((uint32_t)r) >> (32 - bits));
#else
  uint64_t out = 0;
  for (int b = 0; b < bits; ++b) out |= ((r >> b) & 1u) << (bits - 1 - b);
  return (int64_t)out;
#endif
}

// what one row of the program reads: its columns and its successor's (raw
// words), its selectors, its slots (word s at slot[s * slot_step]) and the
// block's uniform words
struct RowView {
  const int32_t* main_l;
  const int32_t* main_n;
  const int32_t* prep_l;
  const int32_t* prep_n;
  const int32_t* perm_l;
  const int32_t* perm_n;
  uint32_t sel[3];
  uint32_t* slot;
  int slot_step;
  const uint32_t* uni;
};

struct Ins {
  int code, dst, a, b;
};

BB_FN Ins load_ins(const int32_t* prog, int pc) {
#if defined(__CUDA_ARCH__)
  const int4 v = __ldg(reinterpret_cast<const int4*>(prog) + pc);
  return Ins{v.x, v.y, v.z, v.w};
#else
  return Ins{prog[4 * pc], prog[4 * pc + 1], prog[4 * pc + 2],
             prog[4 * pc + 3]};
#endif
}

// operand (kind, idx) of a row: 5 words if ext, else word 0 and zeros
BB_FN void fetch(const RowView& r, int kind, int idx, bool ext,
                 uint32_t v[D]) {
  BB_UNROLL
  for (int k = 1; k < D; ++k) v[k] = 0;
  switch (kind) {
    case K_SLOT:
      v[0] = r.slot[idx * r.slot_step];
      if (ext) {
        BB_UNROLL
        for (int k = 1; k < D; ++k) v[k] = r.slot[(idx + k) * r.slot_step];
      }
      break;
    case K_UNI:
      v[0] = r.uni[idx];
      if (ext) {
        BB_UNROLL
        for (int k = 1; k < D; ++k) v[k] = r.uni[idx + k];
      }
      break;
    case K_MAIN_L: v[0] = bbf::canon(r.main_l[idx]); break;
    case K_MAIN_N: v[0] = bbf::canon(r.main_n[idx]); break;
    case K_PREP_L: v[0] = bbf::canon(r.prep_l[idx]); break;
    case K_PREP_N: v[0] = bbf::canon(r.prep_n[idx]); break;
    case K_PERM_L:
      BB_UNROLL
      for (int k = 0; k < D; ++k) v[k] = bbf::canon(r.perm_l[D * idx + k]);
      break;
    case K_PERM_N:
      BB_UNROLL
      for (int k = 0; k < D; ++k) v[k] = bbf::canon(r.perm_n[D * idx + k]);
      break;
    case K_SEL:  // by value, not an index into the array (local memory)
      v[0] = idx == 0 ? r.sel[0] : idx == 1 ? r.sel[1] : r.sel[2];
      break;
    default: v[0] = (uint32_t)idx;  // K_IMM: the Montgomery word itself
  }
}

// z = x op y for ADD, SUB, MUL, NEG; a base operand beside an extension
// one reads as (w, 0, 0, 0, 0), as fetched.  Returns whether z is ext.
// (Every loop over the 5 words is unrolled and every index a constant, so
// the arrays stay in registers on the card.)
BB_FN bool apply(int op, bool ae, bool be, const uint32_t x[D],
                 const uint32_t y[D], uint32_t z[D]) {
  const bool ext = ae || be;
  switch (op) {
    case OP_ADD:
      z[0] = bbf::add(x[0], y[0]);
      if (ext) {
        BB_UNROLL
        for (int k = 1; k < D; ++k) z[k] = bbf::add(x[k], y[k]);
      }
      return ext;
    case OP_SUB:
      z[0] = bbf::sub(x[0], y[0]);
      if (ext) {
        BB_UNROLL
        for (int k = 1; k < D; ++k) z[k] = bbf::sub(x[k], y[k]);
      }
      return ext;
    case OP_NEG:
      z[0] = bbf::neg(x[0]);
      if (ae) {
        BB_UNROLL
        for (int k = 1; k < D; ++k) z[k] = bbf::neg(x[k]);
      }
      return ae;
    default:  // OP_MUL
      if (ae && be) {
        bbf::ext_mul(x, y, z);
      } else if (ae) {
        BB_UNROLL
        for (int k = 0; k < D; ++k) z[k] = bbf::mul(x[k], y[0]);
      } else if (be) {
        BB_UNROLL
        for (int k = 0; k < D; ++k) z[k] = bbf::mul(x[0], y[k]);
      } else {
        z[0] = bbf::mul(x[0], y[0]);
      }
      return ext;
  }
}

// the words of z to dst[k * step], 5 if ext, else one
BB_FN void store(uint32_t* dst, int step, bool ext, const uint32_t z[D]) {
  dst[0] = z[0];
  if (ext) {
    BB_UNROLL
    for (int k = 1; k < D; ++k) dst[k * step] = z[k];
  }
}

// acc += x·y, coefficient-wise in 64 bits (x, y canonical; y an extension
// power of alpha or the base word one)
BB_FN void accumulate(bool ae, bool be, const uint32_t x[D],
                      const uint32_t y[D], uint64_t acc[D]) {
  if (ae && be) {
    uint32_t y2[D];
    BB_UNROLL
    for (int j = 0; j < D; ++j) y2[j] = bbf::add(y[j], y[j]);
    BB_UNROLL
    for (int i = 0; i < D; ++i) {
      BB_UNROLL
      for (int j = 0; j < D; ++j) {
        const int k = (i + j) % D;  // x^5 = 2: a wrapped term doubles
        acc[k] = bbf::fold(acc[k] + (uint64_t)x[i] * (i + j >= D ? y2[j]
                                                                 : y[j]));
      }
    }
  } else if (ae) {
    BB_UNROLL
    for (int k = 0; k < D; ++k)
      acc[k] = bbf::fold(acc[k] + (uint64_t)x[k] * y[0]);
  } else if (be) {
    BB_UNROLL
    for (int k = 0; k < D; ++k)
      acc[k] = bbf::fold(acc[k] + (uint64_t)x[0] * y[k]);
  } else {
    acc[0] = bbf::fold(acc[0] + (uint64_t)x[0] * y[0]);
  }
}

// the uniform program, by one thread: `in` holds the five inputs'
// canonical words (challenges 0-2, alpha, the cumulative sum)
BB_FN void run_uniform(const int32_t* prog, int n, const int32_t* const in[5],
                       uint32_t* uni) {
  RowView r{};
  r.uni = uni;
  for (int pc = 0; pc < n; ++pc) {
    const Ins ins = load_ins(prog, pc);
    const int op = ins.code & 15;
    const bool ae = (ins.code >> 4) & 1, be = (ins.code >> 5) & 1;
    uint32_t x[D], y[D], z[D];
    if (op == OP_LOAD) {
      BB_UNROLL
      for (int k = 0; k < D; ++k)
        uni[ins.dst + k] = bbf::to_monty(bbf::canon(in[ins.a][k]));
      continue;
    }
    fetch(r, (ins.code >> 8) & 15, ins.a, ae, x);
    fetch(r, (ins.code >> 12) & 15, ins.b, be, y);
    store(uni + ins.dst, 1, apply(op, ae, be, x, y, z), z);
  }
}

// the row program over one row: writes the row's [5] quotient value,
// sum_i c_i·alpha^(K-1-i) times zinv, Montgomery
BB_FN void run_row(const int32_t* prog, int n, const RowView& r,
                   uint32_t zinv, int32_t* out) {
  uint64_t acc[D] = {0, 0, 0, 0, 0};
  for (int pc = 0; pc < n; ++pc) {
    const Ins ins = load_ins(prog, pc);
    const int op = ins.code & 15;
    const bool ae = (ins.code >> 4) & 1, be = (ins.code >> 5) & 1;
    uint32_t x[D], y[D], z[D];
    fetch(r, (ins.code >> 8) & 15, ins.a, ae, x);
    if (op != OP_NEG) fetch(r, (ins.code >> 12) & 15, ins.b, be, y);
    if (op == OP_ACC) {
      accumulate(ae, be, x, y, acc);
      continue;
    }
    store(r.slot + ins.dst * r.slot_step, r.slot_step,
          apply(op, ae, be, x, y, z), z);
  }
  BB_UNROLL
  for (int k = 0; k < D; ++k)
    out[k] = (int32_t)bbf::mul(bbf::monty_reduce(acc[k]), zinv);
}

#if !defined(__CUDACC__)
// The launch's function on the host, row by row, as csrc/constraint.cu
// computes it: for quotient row i < R, the buffers' logical rows i and
// (i + 2^qd) mod lq; sel [3, R]; zinv [2^qd] by period; out [R, 5].
// Returns what the entry returns: 0, or its refusal of the parameters.
inline int eval_host(const int32_t* prog, const int32_t* main_lde,
                      const int32_t* prep, const int32_t* perm,
                      const int32_t* sel, const int32_t* zinv,
                      const int32_t* ch, const int32_t* alpha,
                      const int32_t* cum, int32_t* out, const int64_t* p) {
  const int64_t T = block_rows(p, prep != nullptr);
  if (T < 0) return (int)T;
  const int32_t* const in[5] = {ch, ch + D, ch + 2 * D, alpha, cum};
  uint32_t* uni = new uint32_t[p[P_UNI_WORDS] + 1];
  uint32_t* slot = new uint32_t[p[P_SLOT_WORDS] + 1];
  run_uniform(prog, (int)p[P_N_UNIFORM], in, uni);
  const int64_t rows = p[P_ROWS], h = (int64_t)1 << p[P_QD];
  for (int64_t i = 0; i < rows; ++i) {
    const int64_t local = buffer_row(i % p[P_LQ], p);
    const int64_t next = buffer_row((i + h) % p[P_LQ], p);
    RowView r;
    r.main_l = main_lde + local * p[P_W_MAIN];
    r.main_n = main_lde + next * p[P_W_MAIN];
    r.prep_l = prep ? prep + local * p[P_W_PREP] : nullptr;
    r.prep_n = prep ? prep + next * p[P_W_PREP] : nullptr;
    r.perm_l = perm + local * p[P_W_PERM];
    r.perm_n = perm + next * p[P_W_PERM];
    for (int k = 0; k < 3; ++k) r.sel[k] = (uint32_t)sel[k * rows + i];
    r.slot = slot;
    r.slot_step = 1;
    r.uni = uni;
    run_row(prog + 4 * p[P_N_UNIFORM], (int)p[P_N_ROW], r,
            (uint32_t)zinv[i & (h - 1)], out + D * i);
  }
  delete[] uni;
  delete[] slot;
  return 0;
}
#endif

}  // namespace cst
