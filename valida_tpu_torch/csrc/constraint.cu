// One chip's quotient on the card: every row's constraints folded with
// powers of alpha and divided by the zerofier, in one kernel (the row
// interpreter in constraint.cuh, the arithmetic in field.cuh).
//
// No Pallas kernel: the JAX package's quotient stage is `jax.jit` of the
// constraint system (valida_tpu/machine/jit_prover.py:1015), which XLA
// fuses into a few loops over u32 words.  The port's plain path
// (valida_tpu_torch/air/quotient.py `quotient_rows_plain`, VectorBuilder)
// launches one field kernel per operation of the constraint system (some
// 4,000 per prove of the BasicMachine), each a round trip through device
// memory over strided column views.
//
// What bounds it: the integer units.  A row reads its [local, next] words
// once (about 90 words for the cpu chip) and does some 500 field
// operations on them; an interpreter adds its fetch and decode to each.
// The design:
//   (i)   the whole program per row: the instruction stream (global
//         memory, read through the read-only cache; every thread of a
//         warp reads the same instruction, so nothing diverges); live
//         values in per-thread slots in shared memory laid out
//         [slot][thread], free of bank conflicts; uniform values (challenge
//         powers, alpha powers) once per block;
//   (ii)  the block's rows staged through shared memory: the T rows it
//         evaluates and the 2^qd rows after them (each row's successor
//         is row + 2^qd) by coalesced 4-byte cp.async copies, one warp a
//         row; each staged row padded to an odd pitch, so that threads
//         reading one column of consecutive rows hit distinct banks;
//   (iii) the buffers read in place: logical row j is buffer row
//         j·stride, bit-reversed over log_l bits where the caller holds
//         the bit-reversed LDE, so no natural-order gather or roll is
//         copied;
//   (iv)  every constraint folded into 64-bit accumulators in registers
//         as it is made; one [R, 5] result written once.
// Blocks are persistent (a grid of what the SMs hold at once, each
// walking tiles of T rows), so the uniform program runs once per block.
//
// The entry launches on the caller's stream, allocates nothing and does
// not synchronise, so a CUDA graph may capture it; the challenges, alpha
// and the cumulative sum are read from device memory at each run.

#include <cstdint>
#include <cuda_runtime.h>

#include "constraint.cuh"

namespace {

constexpr int MAX_THREADS = 256;  // at least cst::block_rows' largest block

struct Params {
  int64_t v[cst::N_PARAMS];
};

__device__ __forceinline__ void cp_async4(uint32_t* dst, const int32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// rows [j0, j0 + n) of a [*, w] buffer (logical rows, mod lq) into
// shared memory at `pitch` words a row, one warp a row
__device__ __forceinline__ void stage(uint32_t* dst, const int32_t* src,
                                      int64_t w, int64_t pitch, int64_t j0,
                                      int n, const int64_t* p) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int s = threadIdx.x >> 5; s < n; s += warps) {
    const int32_t* row = src + cst::buffer_row((j0 + s) % p[cst::P_LQ], p) * w;
    for (int c = lane; c < w; c += 32) cp_async4(dst + s * pitch + c, row + c);
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
constraint_eval_kernel(const int32_t* __restrict__ prog,
                       const int32_t* __restrict__ main_lde,
                       const int32_t* __restrict__ prep,
                       const int32_t* __restrict__ perm,
                       const int32_t* __restrict__ sel,
                       const int32_t* __restrict__ zinv,
                       const int32_t* __restrict__ ch,
                       const int32_t* __restrict__ alpha,
                       const int32_t* __restrict__ cum,
                       int32_t* __restrict__ out, const Params P) {
  using namespace cst;
  const int64_t* p = P.v;
  extern __shared__ uint32_t smem[];
  const int T = blockDim.x, h = 1 << p[P_QD];
  const int64_t pm = odd_pitch(p[P_W_MAIN]), pp = odd_pitch(p[P_W_PREP]),
                pe = odd_pitch(p[P_W_PERM]);
  uint32_t* uni = smem;
  uint32_t* st_main = uni + p[P_UNI_WORDS];
  uint32_t* st_prep = st_main + (T + h) * pm;
  uint32_t* st_perm = st_prep + (T + h) * pp;
  uint32_t* slots = st_perm + (T + h) * pe;
  if (threadIdx.x == 0) {
    const int32_t* const in[5] = {ch, ch + D, ch + 2 * D, alpha, cum};
    run_uniform(prog, (int)p[P_N_UNIFORM], in, uni);
  }
  const int32_t* row_prog = prog + 4 * p[P_N_UNIFORM];
  const int n_row = (int)p[P_N_ROW];
  const int64_t rows = p[P_ROWS], tiles = (rows + T - 1) / T;
  const int t = threadIdx.x;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t i0 = tile * T;
    __syncthreads();  // the previous tile's rows are read (and uni made)
    stage(st_main, main_lde, p[P_W_MAIN], pm, i0, T + h, p);
    if (prep) stage(st_prep, prep, p[P_W_PREP], pp, i0, T + h, p);
    stage(st_perm, perm, p[P_W_PERM], pe, i0, T + h, p);
    cp_async_wait_all();
    __syncthreads();
    const int64_t i = i0 + t;
    if (i >= rows) continue;
    RowView r;
    r.main_l = (const int32_t*)st_main + t * pm;
    r.main_n = (const int32_t*)st_main + (t + h) * pm;
    r.prep_l = (const int32_t*)st_prep + t * pp;
    r.prep_n = (const int32_t*)st_prep + (t + h) * pp;
    r.perm_l = (const int32_t*)st_perm + t * pe;
    r.perm_n = (const int32_t*)st_perm + (t + h) * pe;
    r.sel[0] = (uint32_t)sel[i];
    r.sel[1] = (uint32_t)sel[rows + i];
    r.sel[2] = (uint32_t)sel[2 * rows + i];
    r.slot = slots + t;
    r.slot_step = T;
    r.uni = uni;
    run_row(row_prog, n_row, r, (uint32_t)zinv[i & (h - 1)], out + D * i);
  }
}

}  // namespace

// prog: int32 [n, 4]; main_lde, perm: [L, w] int32 (prep the same, or
// null);
// sel: [3, R] (is_first_row, is_last_row, is_transition), zinv: [2^qd],
// ch: [3, 5], alpha, cum: [5] canonical; out: [R, 5]; params: host int64
// [N_PARAMS] (constraint.cuh `Param`).  The entry chooses the rows of a
// block (`block_rows`) and returns a negative `Refusal` for parameters it
// does not take, a CUDA error code otherwise.
extern "C" int constraint_eval_launch(const void* prog, const void* main_lde,
                                      const void* prep, const void* perm,
                                      const void* sel, const void* zinv,
                                      const void* ch, const void* alpha,
                                      const void* cum, void* out,
                                      const void* params, void* stream) {
  Params P;
  for (int k = 0; k < cst::N_PARAMS; ++k) P.v[k] = ((const int64_t*)params)[k];
  const int64_t T = cst::block_rows(P.v, prep != nullptr);
  if (T < 0) return (int)T;  // a refusal
  const int64_t bytes = 4 * cst::smem_words(P.v, T), rows = P.v[cst::P_ROWS];
  if (rows == 0) return 0;
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        constraint_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)cst::SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    attribute_set = true;
  }
  // the grid: as many blocks as the SMs hold at once, at most one a tile
  // (queried once for each block size and shared memory)
  static int64_t cached_key = -1, cached_blocks = 0;
  const int64_t key = bytes * 1024 + T;
  if (key != cached_key) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, constraint_eval_kernel, (int)T, (size_t)bytes);
    cached_blocks = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    cached_key = key;
  }
  const int64_t tiles = (rows + T - 1) / T;
  const int blocks = (int)(tiles < cached_blocks ? tiles : cached_blocks);
  constraint_eval_kernel<<<blocks, (int)T, (size_t)bytes,
                           (cudaStream_t)stream>>>(
      (const int32_t*)prog, (const int32_t*)main_lde, (const int32_t*)prep,
      (const int32_t*)perm, (const int32_t*)sel, (const int32_t*)zinv,
      (const int32_t*)ch, (const int32_t*)alpha, (const int32_t*)cum,
      (int32_t*)out, P);
  return (int)cudaGetLastError();
}
