// Integer instruction rates of one SM, for reading the hash and NTT kernels'
// times: every thread runs ITER iterations of 8 independent chains of one
// instruction (or of one Montgomery product), clock64() around the loop.
// kernel_experiments.py builds and times this file; the port never loads it.
#include <cstdint>
#include <cuda_runtime.h>
constexpr int ITER = 4096;
#define CHAINS 8
#define KERNEL(name, decl, body, fold)                                         \
  __global__ void __launch_bounds__(1024) name(uint32_t* out, long long* cyc,  \
                                                uint32_t seed) {                \
    decl;                                                                      \
    const uint32_t b = seed | 1u;                                              \
    long long t0 = clock64();                                                  \
    _Pragma("unroll 1") for (int it = 0; it < ITER; ++it) {                    \
      _Pragma("unroll") for (int c = 0; c < CHAINS; ++c) { body; }             \
    }                                                                          \
    long long t1 = clock64();                                                  \
    uint32_t r = 0;                                                            \
    _Pragma("unroll") for (int c = 0; c < CHAINS; ++c) r ^= fold;              \
    out[blockIdx.x * blockDim.x + threadIdx.x] = r;                            \
    if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;                           \
  }
#define DECL32 uint32_t a[CHAINS]; for (int c = 0; c < CHAINS; ++c) a[c] = threadIdx.x * 2654435761u + c + seed
#define DECL64 uint64_t a[CHAINS]; for (int c = 0; c < CHAINS; ++c) a[c] = threadIdx.x * 2654435761u + c + seed
KERNEL(k_mullo, DECL32, asm volatile("mul.lo.u32 %0, %0, %1;" : "+r"(a[c]) : "r"(b)), a[c])
KERNEL(k_mulhi, DECL32, asm volatile("mul.hi.u32 %0, %0, %1;" : "+r"(a[c]) : "r"(b)), a[c])
KERNEL(k_madwide, DECL64, asm volatile("mad.wide.u32 %0, %1, %2, %0;" : "+l"(a[c]) : "r"((uint32_t)(a[c] >> 0)), "r"(b)), (uint32_t)(a[c] ^ (a[c] >> 32)))
KERNEL(k_mulwide, DECL64, asm volatile("mul.wide.u32 %0, %1, %2;" : "+l"(a[c]) : "r"((uint32_t)(a[c] >> 32)), "r"(b)), (uint32_t)(a[c] ^ (a[c] >> 32)))
KERNEL(k_addmin, DECL32, { uint32_t s = a[c] + b; a[c] = min(s, s - 2013265921u); }, a[c])
KERNEL(k_add, DECL32, asm volatile("add.u32 %0, %0, %1;" : "+r"(a[c]) : "r"(b)), a[c])
KERNEL(k_lop, DECL32, asm volatile("xor.b32 %0, %0, %1;" : "+r"(a[c]) : "r"(b)), a[c])
KERNEL(k_shfadd, DECL32, { a[c] = (a[c] >> 5) + (a[c] << 27) + b; }, a[c])
// Montgomery product as in the kernel, chain on a
__device__ __forceinline__ uint32_t mulp(uint32_t a, uint32_t b) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * 2281701377u;
  const uint32_t u = __umulhi(m, 2013265921u);
  const uint32_t hi = (uint32_t)(t >> 32);
  const uint32_t r = hi - u;
  return hi < u ? r + 2013265921u : r;
}
KERNEL(k_mulp, DECL32; for (int c = 0; c < CHAINS; ++c) a[c] %= 2013265921u, a[c] = mulp(a[c], b % 2013265921u), a[c])
// Montgomery product with m*P's high half from shifts and adds: P = 2^31 - 2^27 + 1
__device__ __forceinline__ uint32_t mulp_sh(uint32_t a, uint32_t b) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * 2281701377u;
  const uint64_t mp = ((uint64_t)m << 31) - ((uint64_t)m << 27) + m;
  const uint32_t u = (uint32_t)(mp >> 32);
  const uint32_t hi = (uint32_t)(t >> 32);
  const uint32_t r = hi - u;
  return min(r, r + 2013265921u);
}
KERNEL(k_mulp_sh, DECL32; for (int c = 0; c < CHAINS; ++c) a[c] %= 2013265921u, a[c] = mulp_sh(a[c], b % 2013265921u), a[c])
// u = hi(m * P) taken from a wide product instead of mul.hi
__device__ __forceinline__ uint32_t mulp_w(uint32_t a, uint32_t b) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * 2281701377u;
  const uint64_t mp = (uint64_t)m * 2013265921u;
  const uint32_t r = (uint32_t)(t >> 32) - (uint32_t)(mp >> 32);
  return min(r, r + 2013265921u);
}
KERNEL(k_mulp_w, DECL32; for (int c = 0; c < CHAINS; ++c) a[c] %= 2013265921u, a[c] = mulp_w(a[c], b % 2013265921u), a[c])
// t - m * P as one 64-bit expression
__device__ __forceinline__ uint32_t mulp_mad(uint32_t a, uint32_t b) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * 2281701377u;          // t * P^-1 mod 2^32
  // t - m*P is a multiple of 2^32 in (-2^32 P, 2^32 P); add 2^32 P first so it is non-negative
  const uint64_t d = t + ((uint64_t)2013265921u << 32) - (uint64_t)m * 2013265921u;
  const uint32_t r = (uint32_t)(d >> 32);                 // in (0, 2P)
  return min(r, r - 2013265921u);
}
KERNEL(k_mulp_mad, DECL32; for (int c = 0; c < CHAINS; ++c) a[c] %= 2013265921u, a[c] = mulp_mad(a[c], b % 2013265921u), a[c])

typedef void (*kern_t)(uint32_t*, long long*, uint32_t);
static kern_t KS[] = {k_mullo, k_mulhi, k_madwide, k_mulwide, k_addmin, k_add, k_lop, k_shfadd, k_mulp, k_mulp_sh, k_mulp_w, k_mulp_mad};
extern "C" int micro_count() { return sizeof(KS) / sizeof(KS[0]); }
extern "C" int micro_iter() { return ITER * CHAINS; }
extern "C" int micro_launch(int which, void* out, void* cyc, int blocks, int threads, void* stream) {
  KS[which]<<<blocks, threads, 0, (cudaStream_t)stream>>>((uint32_t*)out, (long long*)cyc, 12345u);
  return (int)cudaGetLastError();
}
