// NTT kernels over BabyBear (p = 2^31 - 2^27 + 1), natural in, bit-reversed
// out, decimation in frequency along axis 0 of a row-major [n, rest_n] array
// of Montgomery words.
//
//   ntt_dif_whole replaces valida_tpu/poly/mxu_ntt.py::_mega_pallas
//                 (the whole transform, rest_n a multiple of 128);
//   ntt_step      replaces mxu_ntt.py::_step_pallas
//                 (one non-final radix-128 step: product, then twiddle);
//   ntt_tail      replaces mxu_ntt.py::_tail_pallas
//                 (the final M = 1 step: blockwise 128-point transforms,
//                 ntt_step's body with no twiddle).
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
// ntt_step and ntt_tail share one tile routine, y = D·x (mod p) on a
// [128 x TC] column tile, optionally followed by a Montgomery twiddle
// multiply.  The tables are the reference's own: D is the canonical
// [128,128] step matrix (bit-reversed rows, kron(D_R, I) for a radix R < 128)
// and tw the Montgomery twiddles [M4, 128].  Data x is Montgomery, D
// canonical, so the modular product of the two is again Montgomery, as on
// the TPU.  Layout: a step sees the data as x[blocks][128][L], L = M4 *
// rest_n (rest_n = the row width).  A tile is one slab b and TC = 32
// consecutive columns; the column edge is masked, so any width works.  What
// bounds them: integer multiplies, 128 32x32->64 multiply-adds per output
// word on the CUDA cores, about ten times the time the step's bytes need.
// Design: the 64 KB matrix stays in shared memory for every tile a block
// walks over, each thread keeps 16 u64 accumulators (one column, 16 rows)
// and reads the matrix as 16-byte broadcasts; the accumulator is folded as
// hi * (2^32 mod p) + lo after every 4 products (4 (p-1)^2 + 2^60 < 2^64),
// and reduced mod p once at the end.  They serve the widths ntt_dif_whole
// rejects, and await the same redesign.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t P = 2013265921u;
constexpr uint32_t MU = 2281701377u;        // p^-1 mod 2^32
constexpr uint64_t TWO32_MOD_P = 268435454ull;
constexpr int B = 128;
constexpr int TC = 32;                      // columns per tile (one warp)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / TC;         // 8
constexpr int ROWS = B / WARPS;             // 16 output rows per thread
constexpr int SMEM_BYTES = (B * B + B * TC) * 4;  // matrix + x tile: 80 KB

__device__ __forceinline__ uint32_t monty_mul(uint32_t a, uint32_t b) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * MU;
  const uint32_t hi = (uint32_t)(t >> 32);
  const uint32_t mp = __umulhi(m, P);
  const uint32_t r = hi - mp;
  return hi < mp ? r + P : r;
}

// One tile: y[u][c0 + c] for the 128 rows u and TC columns of slab `slab`.
__device__ void tile(const uint32_t* src, uint32_t* dst, const uint32_t* Ds,
                     uint32_t* xs, const uint32_t* tw, size_t slab, int L,
                     int c0, int rest_n) {
  const int tid = threadIdx.x;
  for (int k = tid; k < B * TC; k += THREADS) {
    const int col = c0 + k % TC;
    xs[k] = col < L ? src[slab + (size_t)(k / TC) * L + col] : 0u;
  }
  __syncthreads();
  const int c = tid % TC;
  const int w = tid / TC;
  uint64_t acc[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) acc[k] = 0;
#pragma unroll 2
  for (int i = 0; i < B; i += 4) {
    const uint32_t x0 = xs[i * TC + c];
    const uint32_t x1 = xs[(i + 1) * TC + c];
    const uint32_t x2 = xs[(i + 2) * TC + c];
    const uint32_t x3 = xs[(i + 3) * TC + c];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const uint4 d = *reinterpret_cast<const uint4*>(Ds + (w + WARPS * k) * B + i);
      uint64_t s = acc[k];
      s += (uint64_t)d.x * x0;
      s += (uint64_t)d.y * x1;
      s += (uint64_t)d.z * x2;
      s += (uint64_t)d.w * x3;
      acc[k] = (uint64_t)(uint32_t)(s >> 32) * TWO32_MOD_P + (uint32_t)s;
    }
  }
  __syncthreads();  // xs is refilled by the next tile
  const int col = c0 + c;
  if (col < L) {
    const int t = col / rest_n;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int u = w + WARPS * k;
      uint32_t y = (uint32_t)(acc[k] % P);
      if (tw != nullptr) y = monty_mul(y, __ldg(tw + (size_t)t * B + u));
      dst[slab + (size_t)u * L + col] = y;
    }
  }
}

// One whole step: matrix D into shared memory, then a block-stride walk
// over the blocks * ceil(L / TC) tiles.
__device__ void run_step(const uint32_t* src, uint32_t* dst, const uint32_t* D,
                         const uint32_t* tw, long long blocks, int L,
                         int rest_n, uint32_t* smem) {
  uint32_t* Ds = smem;
  uint32_t* xs = smem + B * B;
  for (int k = threadIdx.x; k < B * B / 4; k += THREADS)
    reinterpret_cast<uint4*>(Ds)[k] = __ldg(reinterpret_cast<const uint4*>(D) + k);
  // the first __syncthreads() of tile() orders these stores before any read
  const long long per_slab = (L + TC - 1) / TC;
  const long long total = blocks * per_slab;
  for (long long item = blockIdx.x; item < total; item += gridDim.x) {
    const long long b = item / per_slab;
    const int c0 = (int)(item % per_slab) * TC;
    tile(src, dst, Ds, xs, tw, (size_t)b * B * L, L, c0, rest_n);
  }
}

__global__ void __launch_bounds__(THREADS)
ntt_step_kernel(const uint32_t* x, uint32_t* y, const uint32_t* D,
                const uint32_t* tw, int blocks, int L, int rest_n) {
  extern __shared__ uint4 smem4[];
  run_step(x, y, D, tw, blocks, L, rest_n, reinterpret_cast<uint32_t*>(smem4));
}

// The same step with no twiddle; a function of its own so that a profile
// tells the tail's time apart from the steps'.
__global__ void __launch_bounds__(THREADS)
ntt_tail_kernel(const uint32_t* x, uint32_t* y, const uint32_t* D,
                const uint32_t* tw, int blocks, int L, int rest_n) {
  extern __shared__ uint4 smem4[];
  run_step(x, y, D, nullptr, blocks, L, rest_n,
           reinterpret_cast<uint32_t*>(smem4));
}

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

// Largest grid whose blocks are all resident at once.
cudaError_t resident_grid(const void* kernel, int* grid) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    SMEM_BYTES);
  if (e != cudaSuccess) return e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *grid = per_sm * sms;
  return *grid > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

int launch_step(const void* x, void* y, const void* D, const void* tw,
                int blocks, int L, int rest_n, void* stream) {
  const auto kernel = tw == nullptr ? ntt_tail_kernel : ntt_step_kernel;
  int grid = 0;
  cudaError_t e = resident_grid((const void*)kernel, &grid);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)blocks * ((L + TC - 1) / TC);
  if (tiles < grid) grid = (int)tiles;
  kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)D,
      (const uint32_t*)tw, blocks, L, rest_n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ntt_step_launch(const void* x, void* y, const void* D,
                               const void* tw, int blocks, int L, int rest_n,
                               void* stream) {
  return launch_step(x, y, D, tw, blocks, L, rest_n, stream);
}

extern "C" int ntt_tail_launch(const void* x, void* y, const void* D,
                               int blocks, int rest_n, void* stream) {
  return launch_step(x, y, D, nullptr, blocks, rest_n, rest_n, stream);
}

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
