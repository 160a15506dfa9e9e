// Batched Poseidon2 sponge over BabyBear (p = 2^31 - 2^27 + 1): words u32
// [batch, n_words] (any u32, taken mod p) -> digests u32 [batch, 8] < p.
// Width 16, rate 8, capacity 8, S-box x^7, 4 + 4 external rounds with
// circ(2*M4, M4, M4, M4), 13 internal rounds (S-box on lane 0, then
// diag*x + sum).
//
// Replaces valida_tpu/crypto/poseidon2.py::_poseidon2_pallas.  The TPU
// kernel transposes the batch into (8, 128) vector tiles, keeps the state as
// 16 such tiles and builds each 64-bit product from 16-bit limbs, because
// the TPU has no 64-bit integers and no dynamic loads.  Here one thread
// hashes one message: the 16 state words live in registers in Montgomery
// form, a Montgomery product is one native 32x32->64 multiply and two
// 32-bit ones, and the absorb loop runs over ceil(n_words / 8) blocks with
// the short last block read as zeros (absorbing 0 is the identity).  Device
// memory sees one read of the message and one write of the digest.
//
// What bounds it: the rate at which the integer pipes take instructions, and
// before that instruction fetch.  A permutation is 772 dependent products
// (8 x 16 x 4 external, 13 x (4 + 16) internal) and some 1,200 modular
// additions for 32 bytes of input; measured on an H100 (NVIDIA H100 80GB
// HBM3, 700 W), the same kernel with its loads removed takes 99% of the
// time, its loads alone 7%, and the SM clock stays at its maximum.  With
// every round unrolled the loop body was 7,880 instructions (126 KB), far
// beyond the instruction caches, and ran at half the dispatch rate whatever
// the occupancy or the number of messages a thread interleaved.  So the
// design is about the instruction stream:
//   * the rounds are loops (one external-round body for both halves, one
//     internal-round body), about 1,000 instructions in all, with the round
//     constants read from constant memory by round index;
//   * the conditional correction of a Montgomery product is a minimum, not
//     a compare and a predicated add; M4 takes 11 additions, not 15; a word
//     is absorbed by the Montgomery product that also reduces it mod p;
//   * a modular addition stays two instructions (add, fused
//     subtract-minimum): p is so close to 2^31 that three unreduced words
//     do not fit 32 bits, so sums cannot be carried lazily.
// The strided row reads (thread i reads 32 bytes at stride n_words * 4)
// hide behind the arithmetic and are left as they are.
//
// The round constants and the diagonal are derived on the host (SHA-256
// expansion, crypto/poseidon2.py) and uploaded once in Montgomery form by
// poseidon2_set_constants.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t P = 2013265921u;   // 2^31 - 2^27 + 1
constexpr uint32_t MU = 2281701377u;  // p^-1 mod 2^32
constexpr uint32_t R2 = 1172168163u;  // 2^64 mod p
constexpr int WIDTH = 16;
constexpr int RATE = 8;
constexpr int HALF_EXTERNAL = 4;
constexpr int INTERNAL = 13;
constexpr int N_CONSTANTS = 2 * HALF_EXTERNAL * WIDTH + INTERNAL + WIDTH;
constexpr int THREADS = 128;

// [0, 128): external round constants, round-major; [128, 141): internal
// round constants; [141, 157): the internal diagonal.  Montgomery form.
__constant__ uint32_t C[N_CONSTANTS];
constexpr int INT_C = 2 * HALF_EXTERNAL * WIDTH;
constexpr int DIAG = INT_C + INTERNAL;

// a + b mod p for a, b < p (the sum stays below 2^32)
__device__ __forceinline__ uint32_t addp(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return min(s, s - P);  // s - P wraps above s exactly when s < P
}

// Montgomery product a * b * 2^-32 mod p, in [0, p), for any a, b with
// a * b < 2^32 * p: both below p, or any u32 a with b < p.  Then
// hi = t >> 32 < p and u < p; the low halves of t and m * P are equal, so
// (t - m * P) / 2^32 = hi - u exactly, in (-p, p).  A negative difference
// wraps, and adding P wraps it back below itself; a non-negative one only
// grows (r + P < 2^32), so the minimum is the reduced value.
__device__ __forceinline__ uint32_t mulp(uint32_t a, uint32_t b) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * MU;
  const uint32_t r = (uint32_t)(t >> 32) - __umulhi(m, P);
  return min(r, r + P);
}

__device__ __forceinline__ uint32_t sbox7(uint32_t x) {
  const uint32_t x2 = mulp(x, x);
  const uint32_t x4 = mulp(x2, x2);
  return mulp(mulp(x4, x2), x);
}

// circ(2*M4, M4, M4, M4): M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] on
// each block of four lanes, then every lane gains the sum over the blocks.
// M4 in 11 additions: with a = x0 + x1, b = x2 + x3, t = a + b,
// u = t + x1 and v = t + x3, the rows are u + a, u + 2 x2, v + b, v + 2 x0.
__device__ __forceinline__ void external_linear(uint32_t s[WIDTH]) {
#pragma unroll
  for (int k = 0; k < WIDTH; k += 4) {
    const uint32_t x0 = s[k], x1 = s[k + 1], x2 = s[k + 2], x3 = s[k + 3];
    const uint32_t a = addp(x0, x1), b = addp(x2, x3);
    const uint32_t t = addp(a, b);
    const uint32_t u = addp(t, x1), v = addp(t, x3);
    s[k] = addp(u, a);                 // 2 x0 + 3 x1 + x2 + x3
    s[k + 1] = addp(u, addp(x2, x2));  // x0 + 2 x1 + 3 x2 + x3
    s[k + 2] = addp(v, b);             // x0 + x1 + 2 x2 + 3 x3
    s[k + 3] = addp(v, addp(x0, x0));  // 3 x0 + x1 + x2 + 2 x3
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t total = addp(addp(s[i], s[4 + i]), addp(s[8 + i], s[12 + i]));
#pragma unroll
    for (int k = 0; k < WIDTH; k += 4) s[k + i] = addp(s[k + i], total);
  }
}

__device__ __forceinline__ void external_round(uint32_t s[WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = sbox7(addp(s[i], C[r * WIDTH + i]));
  external_linear(s);
}

__device__ __forceinline__ void internal_rounds(uint32_t s[WIDTH]) {
#pragma unroll 1
  for (int r = 0; r < INTERNAL; ++r) {
    s[0] = sbox7(addp(s[0], C[INT_C + r]));
    uint32_t t[WIDTH / 2];
#pragma unroll
    for (int i = 0; i < WIDTH / 2; ++i) t[i] = addp(s[2 * i], s[2 * i + 1]);
    const uint32_t total =
        addp(addp(addp(t[0], t[1]), addp(t[2], t[3])),
             addp(addp(t[4], t[5]), addp(t[6], t[7])));
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = addp(mulp(s[i], C[DIAG + i]), total);
  }
}

// The rounds stay loops, and both halves of the external rounds share one
// loop body: the code has to fit the instruction caches (see the head of
// this file).
__device__ __forceinline__ void permute(uint32_t s[WIDTH]) {
  external_linear(s);
#pragma unroll 1
  for (int r = 0; r < 2 * HALF_EXTERNAL; ++r) {
    if (r == HALF_EXTERNAL) internal_rounds(s);
    external_round(s, r);
  }
}

// Stating a minimum of one block an SM makes ptxas schedule with 44
// registers a thread instead of 32; the longer reach of its scheduling is
// worth more than the warps it costs (40 an SM instead of 64): 5.39 against
// 5.95 ms at 2^20 x 128 on an NVIDIA H100 80GB HBM3 at 700 W.
__global__ void __launch_bounds__(THREADS, 1)
poseidon2_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ out,
                 int batch, int n_words) {
  const int msg = blockIdx.x * THREADS + threadIdx.x;
  if (msg >= batch) return;
  const uint32_t* row = words + (size_t)msg * n_words;
  uint32_t s[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = 0;
#pragma unroll 1
  for (int base = 0; base < n_words; base += RATE) {
#pragma unroll
    for (int i = 0; i < RATE; ++i) {
      const uint32_t w = base + i < n_words ? row[base + i] : 0u;
      // any u32 w: w * R2 < 2^32 * p, so the product is w * 2^32 mod p,
      // reduced: to Montgomery form and mod p in one step; then absorb
      s[i] = addp(s[i], mulp(w, R2));
    }
    permute(s);
  }
  uint32_t* o = out + (size_t)msg * RATE;
#pragma unroll
  for (int i = 0; i < RATE; ++i) o[i] = mulp(s[i], 1u);  // canonical form
}

}  // namespace

// host_words: N_CONSTANTS u32 in host memory, laid out as C above.
extern "C" int poseidon2_set_constants(const void* host_words, int n) {
  if (n != N_CONSTANTS) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyToSymbol(C, host_words, sizeof(uint32_t) * N_CONSTANTS);
}

extern "C" int poseidon2_launch(const void* words, void* out, int batch,
                                int n_words, void* stream) {
  const int grid = (batch + THREADS - 1) / THREADS;
  poseidon2_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (uint32_t*)out, batch, n_words);
  return (int)cudaGetLastError();
}
