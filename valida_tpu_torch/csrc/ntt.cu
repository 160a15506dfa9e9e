// Radix-128 four-step NTT steps over BabyBear (p = 2^31 - 2^27 + 1).
//
// Three kernels share one tile routine, y = D·x (mod p) on a [128 x TC]
// column tile, optionally followed by a Montgomery twiddle multiply:
//   ntt_step      replaces valida_tpu/poly/mxu_ntt.py::_step_pallas
//                 (one non-final step: product, then twiddle tw[t, u]);
//   ntt_tail      replaces mxu_ntt.py::_tail_pallas
//                 (the final M = 1 step: blockwise 128-point transforms,
//                 ntt_step's body with no twiddle);
//   ntt_dif_whole replaces mxu_ntt.py::_mega_pallas
//                 (every step of the DIF in one launch).
// The tables are the reference's own: D is the canonical [128,128] step
// matrix (bit-reversed rows, kron(D_R, I) for a radix R < 128) and tw the
// Montgomery twiddles [M4, 128].  Data x is Montgomery, D canonical, so the
// modular product of the two is again Montgomery, as on the TPU.
//
// Layout: a step sees the data as x[blocks][128][L], L = M4 * rest_n
// (rest_n = the row width).  A tile is one slab b and TC = 32 consecutive
// columns; the column edge is masked, so any width works.
//
// What bounds it: integer multiplies.  The TPU computes the product on its
// matrix unit with int8 digits; this kernel does 128 32x32->64 multiply-adds
// per output word on the CUDA cores, some 2^34 of them per step at
// 2^20 x 128, about ten times the time the step's bytes need.  Design: the
// 64 KB matrix stays in shared memory for every tile a block walks over,
// each thread keeps 16 u64 accumulators (one column, 16 rows) and reads the
// matrix as 16-byte broadcasts; the accumulator is folded as
// hi * (2^32 mod p) + lo after every 4 products (4 (p-1)^2 + 2^60 < 2^64),
// and reduced mod p once at the end.  Tensor-core digits (wgmma) and TMA
// staging are later work.
//
// ntt_dif_whole is a persistent cooperative kernel: its grid is the number
// of blocks that fit on the card at once (a larger grid would deadlock at
// the grid barrier), every block walks over the (slab, tile) items of a
// step, and cooperative_groups' grid.sync() separates the steps.  Steps
// ping-pong between the output and a scratch buffer so that the last one
// lands in the output (mxu_ntt.py:594-604).

#include <cstdint>
#include <cuda_runtime.h>
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t P = 2013265921u;
constexpr uint32_t MU = 2281701377u;        // p^-1 mod 2^32
constexpr uint64_t TWO32_MOD_P = 268435454ull;
constexpr int B = 128;
constexpr int LOG_B = 7;
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
// src is read with plain loads: in ntt_dif_whole it was written by other
// blocks earlier in the same launch.
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

__global__ void __launch_bounds__(THREADS)
ntt_dif_whole_kernel(const uint32_t* x, uint32_t* out, uint32_t* scr,
                     const uint32_t* mats, const uint32_t* tws, int log_n,
                     int rest_n) {
  extern __shared__ uint4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int r0 = log_n % LOG_B;
  const int k_steps = log_n / LOG_B + (r0 ? 1 : 0);
  const uint32_t* src = x;
  long long blocks = 1;
  int log_len = log_n;
  size_t tw_off = 0;
  for (int si = 0; si < k_steps; ++si) {
    const int radix_log = (si == 0 && r0) ? r0 : LOG_B;
    const bool last = si == k_steps - 1;
    uint32_t* dst = ((k_steps - 1 - si) % 2 == 0) ? out : scr;
    const int m4 = last ? 1 : 1 << (log_len - LOG_B);
    run_step(src, dst, mats + (size_t)si * B * B, last ? nullptr : tws + tw_off,
             blocks, m4 * rest_n, rest_n, smem);
    if (!last) tw_off += (size_t)m4 * B;
    grid.sync();
    src = dst;
    blocks <<= radix_log;
    log_len -= radix_log;
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

extern "C" int ntt_dif_whole_launch(const void* x, void* out, void* scr,
                                    const void* mats, const void* tws,
                                    int log_n, int rest_n, void* stream) {
  int grid = 0;
  cudaError_t e = resident_grid((const void*)ntt_dif_whole_kernel, &grid);
  if (e != cudaSuccess) return (int)e;
  const uint32_t* xa = (const uint32_t*)x;
  uint32_t* oa = (uint32_t*)out;
  uint32_t* sa = (uint32_t*)scr;
  const uint32_t* ma = (const uint32_t*)mats;
  const uint32_t* ta = (const uint32_t*)tws;
  void* args[] = {&xa, &oa, &sa, &ma, &ta, &log_n, &rest_n};
  e = cudaLaunchCooperativeKernel((const void*)ntt_dif_whole_kernel, dim3(grid),
                                  dim3(THREADS), args, SMEM_BYTES,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
