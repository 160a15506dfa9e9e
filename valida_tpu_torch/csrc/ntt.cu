// NTT kernels over BabyBear (p = 2^31 - 2^27 + 1), natural in, bit-reversed
// out, decimation in frequency along axis 0 of a row-major [n, rest_n] array
// of Montgomery words.
//
//   ntt_dif_whole  replaces valida_tpu/poly/mxu_ntt.py::_mega_pallas
//                  (the whole transform, rest_n a multiple of 128);
//   ntt_dif_ragged replaces mxu_ntt.py::_step_pallas and ::_tail_pallas
//                  together (the TPU's radix-128 four-step transform, one
//                  kernel a step: every other width).
//
// ntt_dif_whole: radix-2 butterflies in shared memory.  The TPU kernel runs
// 7 levels at once as an exact [128,128] modular matrix product, because the
// TPU has a matrix unit and no cheap butterflies; on the CUDA cores that is
// 128 wide multiply-adds per word per step, 18 times the multiplies of the
// log_n butterfly levels themselves.  Natural-in, bit-reversed-out DIF needs
// no reordering at all: level s pairs row j with row j + h, h = n >> (s+1),
// in place, and multiplies the difference by pw[(j mod h) << s], pw the n/2
// Montgomery powers of the root (poly/ntt.py::_root_powers, 2 MB at 2^20,
// resident in L2).  The levels are split into passes of at most 11; a pass
// loads a tile of 2^T rows x C columns (64 KB: C = 16 words at T = 10) into
// shared memory with 16-byte cp.async copies, runs its T levels there, two
// levels a barrier (radix-4 in registers: 4 rows x 4 columns a thread), and
// writes the tile back once.  The first pass's rows lie n >> T apart, but
// each row piece is C consecutive words (whole 32-byte sectors); the last
// pass's rows are contiguous.  Pass 1 reads x and writes out, later passes
// run in place on out, so there is no scratch array.  What bounds it: the
// function's least at 2^20 x 128 is 0.32 ms twice over, the array read once
// and written once at 3.35 TB/s, and 1.34e9 butterflies of 3 multiplies and
// 5 other integer instructions, 4 issue slots each when the two integer
// units share the others, at 64 per clock per SM.  This design moves the
// array once per pass (two passes: 0.64 ms) and adds shared-memory traffic,
// index arithmetic and barriers to the 8 instructions of a butterfly (the
// difference is left unreduced for the Montgomery product); it overlaps
// memory and arithmetic across the three blocks resident on an SM: while
// one loads, two compute.  Tensor cores are not used: int8 digit products
// (the TPU's scheme on wgmma) need 16 digit products per word per step,
// about 0.8 ms at the int8 peak, above the butterflies' least, for far more
// code.
//
// ntt_dif_ragged: the same passes, row sets, twiddles and radix-4 rounds for
// a width that is no multiple of 128 (51 and 10 columns on the PCS paths, 32
// at the entry's commit).  The TPU splits the transform into steps of 7
// levels because its matrix unit does 7 levels as one [128,128] product,
// with a twiddle between steps and none after the last (_step_pallas,
// _tail_pallas); butterflies need neither the matrices nor the split, so one
// kernel computes what the two compute together.  What bounds it: at 2^20 x
// 51 the least is 0.128 ms twice over, 2 * 2^20 * 51 words and the 2 MB
// table at 3.35 TB/s, and 2^19 * 20 * 51 butterflies at 4 issue slots.  What
// the whole-width kernel may assume and this one may not:
// - rows of 51 or 10 words are not 16-byte aligned, so the tile is loaded
//   with 4-byte cp.async copies (.ca, with a 128-byte L2 prefetch, 3%
//   faster) and a thread holds one word of a row, not four;
// - the columns are cut into the fewest groups of at most 2^14 >> T words,
//   as even as they go (ragged_columns: 51 = 13+13+13+12 at T = 10, 10 is
//   one group), and the block of a group narrower than the others lays its
//   threads out on its own width, so it does only its own arithmetic;
// - a piece of a row that starts inside a 32-byte sector moves a sector
//   more than it holds, and with 51 words a row every piece but the first
//   does: on the H100 the first pass at 2^20 x 51 in 13-word pieces takes
//   0.43 ms against 0.32 for the second (experiments/kernel_experiments.py
//   times these variants).  Above the L2's size the caller therefore
//   asks for passes short enough that a tile holds whole rows (t_max 8:
//   7+7+6 levels at 2^20 x 51), one pass more for whole sectors
//   (poly/radix_ntt.py::_ragged_t_max);
// - a thread's column lane c and row slot r are fixed for the whole pass
//   (c = tid mod w, r = tid / w, one division a block), so the level loops
//   divide by nothing; a warp covers 32 consecutive (slot, lane) places;
// - the tile's row stride is the group's width w: while a radix-4 round
//   pairs neighbouring rows (every round but the last), a warp's 32 words
//   are consecutive in shared memory, so they fall on 32 banks.
// Blocks are numbered column group first, then `low`, as in ntt_dif_whole,
// so the first pass's short pieces are merged in L2 across blocks in flight.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t P = 2013265921u;
constexpr uint32_t MU = 2281701377u;        // p^-1 mod 2^32

// ---------------------------------------------------------------------------
// ntt_dif_whole: radix-2 butterflies in shared memory
// ---------------------------------------------------------------------------

constexpr int TILE_LOG = 14;        // a tile holds at most 2^14 words, 64 KB
constexpr int W_T_MAX = 11;         // most levels of one pass
constexpr int W_THREADS = 256;
constexpr int W_BLOCKS_PER_SM = 3;  // 3 x (64 KB tile + twiddles) fit an SM

// a + b mod p for a, b < p: the sum stays below 2p < 2^32, and s - P wraps
// above s exactly when s < P
__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return min(s, s - P);
}

// Montgomery product d * w * 2^-32 mod p in [0, p) for ANY u32 d and w < p:
// t = d * w < 2^32 * p, so hi = t >> 32 < p; mp = (m * P) >> 32 < p; the low
// halves of t and m * P are equal, so (t - m * P) / 2^32 = hi - mp exactly,
// in (-p, p).  A negative difference wraps, and adding P wraps it back
// below the wrapped value; a non-negative one only grows (r + P < 2^32).
__device__ __forceinline__ uint32_t monty_mul_wide(uint32_t d, uint32_t w) {
  const uint64_t t = (uint64_t)d * w;
  const uint32_t m = (uint32_t)t * MU;
  const uint32_t r = (uint32_t)(t >> 32) - __umulhi(m, P);
  return min(r, r + P);
}

// One DIF butterfly on words a, b < p: a <- a + b, b <- (a - b) * w.  The
// difference is left unreduced as a + P - b, in (0, 2p) and so a u32, which
// monty_mul_wide takes; both results are fully reduced.
__device__ __forceinline__ void butterfly(uint32_t& a, uint32_t& b, uint32_t w) {
  const uint32_t d = a + P - b;
  a = add_mod(a, b);
  b = monty_mul_wide(d, w);
}

__device__ __forceinline__ void butterfly4(uint4& a, uint4& b, uint32_t w) {
  butterfly(a.x, b.x, w);
  butterfly(a.y, b.y, w);
  butterfly(a.z, b.z, w);
  butterfly(a.w, b.w, w);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(__cvta_generic_to_global(gmem))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Position, in 16-byte units, of unit q of tile row i.  Rows are Q = 2^q_log
// units long.  A 16-byte shared-memory access is served a quarter warp (8
// threads, 128 bytes) at a time; with Q < 8 a quarter warp spans 8 / Q rows,
// which in the last round lie 4 rows apart and would share their banks.
// XOR-ing the row's low bits with bits 2.. of the row index spreads them:
// rows i0 + 4 g land on different banks, and 8 / Q consecutive rows (which
// share their bits 2..) still do.
__device__ __forceinline__ int unit_at(int i, int q, int q_log) {
  int u = (i << q_log) | q;
  if (q_log < 3) u ^= ((i >> 2) & ((8 >> q_log) - 1)) << q_log;
  return u;
}

// One pass: levels s0 .. s0 + T - 1 of the order-2^log_n DIF, in place in
// shared memory.  A row set is the 2^T rows
//     (hi << (log_n - s0)) + i * S + low,  i < 2^T,  S = 2^(log_n - s0 - T),
// that these levels pair among themselves; a block takes one tile, a row
// set's column group of C = 4 * 2^q_log words.  Blocks are numbered with the
// column group fastest and then `low`, so blocks that run at the same time
// read neighbouring pieces of the same rows and neighbouring rows: device
// memory sees whole rows although a block's own pieces are short and far
// apart (measured: 1.41 -> 1.18 ms against numbering row sets first).  The
// tile's twiddles are staged in shared memory.  Local level lv pairs tile rows
// i and i + hl, hl = 2^(T - 1 - lv), and multiplies the difference by
//     pw[((i mod hl) * S + low) << (s0 + lv)],
// which is the whole transform's pw[(j mod h) << s] at level s = s0 + lv,
// h = n >> (s + 1) = hl * S, for the global row j.  The twiddle of (lv, k) is
// kept at tws[2^(T-1-lv) | k].  src is x for the first pass and out after.
__global__ void __launch_bounds__(W_THREADS, W_BLOCKS_PER_SM)
ntt_dif_whole_kernel(const uint32_t* src, uint32_t* dst,
                     const uint32_t* __restrict__ pw, int log_n, int s0, int T,
                     int q_log, int rest_n) {
  extern __shared__ uint4 smem4[];
  uint4* buf = smem4;
  const int n_units = 1 << (T + q_log);
  uint32_t* tws = reinterpret_cast<uint32_t*>(smem4 + n_units);
  const int tid = threadIdx.x;
  const int Q = 1 << q_log;
  const int s_log = log_n - s0 - T;
  const unsigned groups = rest_n >> (q_log + 2);  // column groups a row set
  const unsigned row_set = blockIdx.x / groups;
  const unsigned cg = blockIdx.x % groups;
  const size_t low = row_set & ((1u << s_log) - 1);
  const size_t hi = row_set >> s_log;
  const size_t base =
      ((hi << (log_n - s0)) + low) * rest_n + ((size_t)cg << (q_log + 2));

  for (int e = 1 + tid; e < (1 << T); e += W_THREADS) {
    const int top = 31 - __clz(e);  // level T - 1 - top, butterfly e - 2^top
    const size_t k = e - (1 << top);
    tws[e] = __ldg(pw + (((k << s_log) + low) << (s0 + T - 1 - top)));
  }

  for (int u = tid; u < n_units; u += W_THREADS) {
    const int i = u >> q_log, q = u & (Q - 1);
    cp_async16(buf + unit_at(i, q, q_log),
               src + base + ((size_t)i << s_log) * rest_n + 4 * q);
  }
  cp_async_wait_all();
  __syncthreads();  // orders the twiddle stores above too

  int l = 0;
  if (T & 1) {  // odd T: one radix-2 round first, rows i and i + 2^(T-1)
    const int hl = 1 << (T - 1);
    for (int t = tid; t < n_units / 2; t += W_THREADS) {
      const int q = t & (Q - 1), g = t >> q_log;
      const int u0 = unit_at(g, q, q_log), u1 = unit_at(g + hl, q, q_log);
      uint4 x0 = buf[u0], x1 = buf[u1];
      butterfly4(x0, x1, tws[hl | g]);
      buf[u0] = x0;
      buf[u1] = x1;
    }
    __syncthreads();
    l = 1;
  }
  // radix-4 rounds: levels l and l + 1 on rows i0 + m * st, m < 4, in
  // registers; i0 = (a << (T - l)) | b with b < st = 2^(T-l-2)
  for (; l < T; l += 2) {
    const int sub = T - l - 2;
    const int st = 1 << sub;
    for (int t = tid; t < n_units / 4; t += W_THREADS) {
      const int q = t & (Q - 1), g = t >> q_log;
      const int b = g & (st - 1);
      const int i0 = ((g >> sub) << (sub + 2)) | b;
      const int u0 = unit_at(i0, q, q_log);
      const int u1 = unit_at(i0 + st, q, q_log);
      const int u2 = unit_at(i0 + 2 * st, q, q_log);
      const int u3 = unit_at(i0 + 3 * st, q, q_log);
      uint4 x0 = buf[u0], x1 = buf[u1], x2 = buf[u2], x3 = buf[u3];
      // level l: hl = 2 st, rows i0 + {0, st} against i0 + {2 st, 3 st}
      butterfly4(x0, x2, tws[(2 * st) | b]);
      butterfly4(x1, x3, tws[(2 * st) | st | b]);
      // level l + 1: hl = st, both pairs at butterfly b
      const uint32_t w = tws[st | b];
      butterfly4(x0, x1, w);
      butterfly4(x2, x3, w);
      buf[u0] = x0;
      buf[u1] = x1;
      buf[u2] = x2;
      buf[u3] = x3;
    }
    __syncthreads();
  }

  for (int u = tid; u < n_units; u += W_THREADS) {
    const int i = u >> q_log, q = u & (Q - 1);
    *reinterpret_cast<uint4*>(dst + base + ((size_t)i << s_log) * rest_n +
                              4 * q) = buf[unit_at(i, q, q_log)];
  }
}

// ---------------------------------------------------------------------------
// ntt_dif_ragged: the same passes on any width, one word a thread
// ---------------------------------------------------------------------------

constexpr int R_TILE_WORDS = 1 << 14;  // a tile holds at most 2^14 words
constexpr int R_THREADS = 256;
constexpr int R_BLOCKS_PER_SM = 3;

__device__ __forceinline__ void cp_async4(uint32_t* smem,
                                          const uint32_t* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 4;\n"
               ::"r"(s),
               "l"(__cvta_generic_to_global(gmem))
               : "memory");
}

// Width of a column group of a pass of T levels: the fewest groups of at
// most min(R_TILE_WORDS >> T, R_THREADS) columns, as even as they go; every
// group but the last is this wide (poly/radix_ntt.py::_column_groups).
int ragged_columns(int rest_n, int T) {
  int c_max = R_TILE_WORDS >> T;
  if (c_max > R_THREADS) c_max = R_THREADS;
  const int k = (rest_n + c_max - 1) / c_max;
  return (rest_n + k - 1) / k;
}

// One pass, as ntt_dif_whole_kernel's, on the tile of row set blockIdx.x /
// groups and its column group blockIdx.x mod groups: columns c0 .. c0 + w - 1,
// w = min(C, rest_n - c0).  Word (i, c) of the tile sits at buf[i * w + c];
// the twiddle of (lv, k) at tws[2^(T-1-lv) | k].
__global__ void __launch_bounds__(R_THREADS, R_BLOCKS_PER_SM)
ntt_dif_ragged_kernel(const uint32_t* src, uint32_t* dst,
                      const uint32_t* __restrict__ pw, int log_n, int s0,
                      int T, int C, int rest_n) {
  extern __shared__ uint32_t smem[];
  const int n_rows = 1 << T;
  uint32_t* tws = smem;
  uint32_t* buf = smem + n_rows;
  const int tid = threadIdx.x;
  const int s_log = log_n - s0 - T;
  const unsigned groups = (rest_n + C - 1) / C;
  const unsigned row_set = blockIdx.x / groups;
  const int c0 = (int)(blockIdx.x - row_set * groups) * C;
  const int w = min(C, rest_n - c0);
  const int c = tid % w, r = tid / w;  // fixed for the whole pass
  const int R = R_THREADS / w;         // row slots; threads r >= R idle
  const bool active = r < R;
  const size_t low = row_set & ((1u << s_log) - 1);
  const size_t hi = row_set >> s_log;
  const size_t offset = ((hi << (log_n - s0)) + low) * rest_n + c0 + c;
  const size_t row_step = (size_t)rest_n << s_log;

  for (int e = 1 + tid; e < n_rows; e += R_THREADS) {
    const int top = 31 - __clz(e);  // level T - 1 - top, butterfly e - 2^top
    const size_t k = e - (1 << top);
    tws[e] = __ldg(pw + (((k << s_log) + low) << (s0 + T - 1 - top)));
  }
  if (active)
    for (int i = r; i < n_rows; i += R)
      cp_async4(buf + i * w + c, src + offset + i * row_step);
  cp_async_wait_all();
  __syncthreads();  // orders the twiddle stores above too

  int l = 0;
  if (T & 1) {  // odd T: one radix-2 round first, rows g and g + 2^(T-1)
    const int hl = n_rows >> 1;
    const int hw = hl * w;
    if (active)
      for (int g = r; g < hl; g += R) {
        uint32_t* p = buf + g * w + c;
        uint32_t x0 = p[0], x1 = p[hw];
        butterfly(x0, x1, tws[hl | g]);
        p[0] = x0;
        p[hw] = x1;
      }
    __syncthreads();
    l = 1;
  }
  // radix-4 rounds: levels l and l + 1 on rows i0 + m * st, m < 4, in
  // registers; i0 = (a << (T - l)) | b with b < st = 2^(T-l-2)
  for (; l < T; l += 2) {
    const int sub = T - l - 2;
    const int st = 1 << sub;
    const int sw = st * w;
    if (active)
      for (int g = r; g < n_rows >> 2; g += R) {
        const int b = g & (st - 1);
        const int i0 = ((g >> sub) << (sub + 2)) | b;
        uint32_t* p = buf + i0 * w + c;
        uint32_t x0 = p[0], x1 = p[sw], x2 = p[2 * sw], x3 = p[3 * sw];
        // level l: hl = 2 st, rows i0 + {0, st} against i0 + {2 st, 3 st}
        butterfly(x0, x2, tws[(2 * st) | b]);
        butterfly(x1, x3, tws[(2 * st) | st | b]);
        // level l + 1: hl = st, both pairs at butterfly b
        const uint32_t tw = tws[st | b];
        butterfly(x0, x1, tw);
        butterfly(x2, x3, tw);
        p[0] = x0;
        p[sw] = x1;
        p[2 * sw] = x2;
        p[3 * sw] = x3;
      }
    __syncthreads();
  }

  if (active)
    for (int i = r; i < n_rows; i += R)
      dst[offset + i * row_step] = buf[i * w + c];
}

}  // namespace

// The whole DIF as k = ceil(log_n / t_max) passes of floor(log_n / k) levels,
// the first log_n mod k of them one level more (poly/radix_ntt.py
// ::_pass_levels), one launch each on the same stream, a block a tile.  The
// first pass reads x and writes out, the later ones run in place on out: a
// block owns its tile.  pw: the n / 2 Montgomery powers of the order-n root
// (of its inverse for the inverse transform).
extern "C" int ntt_dif_whole_launch(const void* x, void* out, const void* pw,
                                    int log_n, int rest_n, int t_max,
                                    void* stream) {
  if (log_n < 1 || log_n > 30 || t_max < 1 || t_max > W_T_MAX ||
      rest_n < 128 || rest_n % 128 != 0)
    return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)ntt_dif_whole_kernel;
  const int max_smem = (4 << TILE_LOG) + (4 << W_T_MAX);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (e != cudaSuccess) return (int)e;
  const int k = (log_n + t_max - 1) / t_max;
  const uint32_t* src = (const uint32_t*)x;
  int s0 = 0;
  for (int p = 0; p < k; ++p) {
    const int T = log_n / k + (p < log_n % k ? 1 : 0);
    const int q_log = TILE_LOG - 2 - T < 5 ? TILE_LOG - 2 - T : 5;
    const int smem = (16 << (T + q_log)) + (4 << T);
    const long long tiles =
        (1ll << (log_n - T)) * (long long)(rest_n >> (q_log + 2));
    if (tiles > 0x7fffffffll) return (int)cudaErrorInvalidValue;
    ntt_dif_whole_kernel<<<(unsigned)tiles, W_THREADS, smem,
                           (cudaStream_t)stream>>>(
        src, (uint32_t*)out, (const uint32_t*)pw, log_n, s0, T, q_log, rest_n);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    src = (const uint32_t*)out;
    s0 += T;
  }
  return (int)cudaSuccess;
}

// The whole DIF of any width in ntt_dif_whole_launch's passes, one launch
// each on the same stream, a block a tile: a row set's 2^T rows x one column
// group of ragged_columns(rest_n, T) columns (fewer in the last group).
extern "C" int ntt_dif_ragged_launch(const void* x, void* out, const void* pw,
                                     int log_n, int rest_n, int t_max,
                                     void* stream) {
  if (log_n < 1 || log_n > 30 || t_max < 1 || t_max > W_T_MAX || rest_n < 1)
    return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)ntt_dif_ragged_kernel;
  const int max_smem = 4 * R_TILE_WORDS + (4 << W_T_MAX);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (e != cudaSuccess) return (int)e;
  const int k = (log_n + t_max - 1) / t_max;
  const uint32_t* src = (const uint32_t*)x;
  int s0 = 0;
  for (int p = 0; p < k; ++p) {
    const int T = log_n / k + (p < log_n % k ? 1 : 0);
    const int C = ragged_columns(rest_n, T);
    const int smem = 4 * ((C << T) + (1 << T));
    const long long tiles =
        (1ll << (log_n - T)) * (long long)((rest_n + C - 1) / C);
    if (tiles > 0x7fffffffll) return (int)cudaErrorInvalidValue;
    ntt_dif_ragged_kernel<<<(unsigned)tiles, R_THREADS, smem,
                            (cudaStream_t)stream>>>(
        src, (uint32_t*)out, (const uint32_t*)pw, log_n, s0, T, C, rest_n);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    src = (const uint32_t*)out;
    s0 += T;
  }
  return (int)cudaSuccess;
}
