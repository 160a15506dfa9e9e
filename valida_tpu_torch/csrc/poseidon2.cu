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
// 32-bit ones, the rounds are fully unrolled so every round constant is a
// constant-memory operand, and the absorb loop runs over ceil(n_words / 8)
// blocks with the short last block read as zeros (absorbing 0 is the
// identity).  Device memory sees one read of the message and one write of
// the digest.
//
// What bounds it: the integer units.  A permutation is 772 dependent
// Montgomery products (8 x 16 x 4 external, 13 x (4 + 16) internal) and
// 1,336 modular additions for 32 bytes of input, far above the card's
// ratio of integer operations to memory bytes; the compiler fuses each
// conditional subtraction into one add-minimum instruction.  The design
// keeps the whole state in registers (39 a thread, so the SMs stay fully
// occupied) and touches memory only to read the message and write the
// digest.  Neighbouring threads read rows n_words apart, which does not
// coalesce; staging rows through shared memory is left to a later change.
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

// Montgomery product a * b * 2^-32 mod p for a, b < p
__device__ __forceinline__ uint32_t mulp(uint32_t a, uint32_t b) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * MU;
  const uint32_t u = __umulhi(m, P);
  const uint32_t hi = (uint32_t)(t >> 32);
  const uint32_t r = hi - u;
  return hi < u ? r + P : r;
}

__device__ __forceinline__ uint32_t sbox7(uint32_t x) {
  const uint32_t x2 = mulp(x, x);
  const uint32_t x4 = mulp(x2, x2);
  return mulp(mulp(x4, x2), x);
}

// circ(2*M4, M4, M4, M4): M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] on
// each block of four lanes, then every lane gains the sum over the blocks.
__device__ __forceinline__ void external_linear(uint32_t s[WIDTH]) {
#pragma unroll
  for (int b = 0; b < WIDTH; b += 4) {
    const uint32_t x0 = s[b], x1 = s[b + 1], x2 = s[b + 2], x3 = s[b + 3];
    const uint32_t t = addp(addp(x0, x1), addp(x2, x3));
    s[b] = addp(addp(t, x0), addp(x1, x1));      // 2 x0 + 3 x1 + x2 + x3
    s[b + 1] = addp(addp(t, x1), addp(x2, x2));  // x0 + 2 x1 + 3 x2 + x3
    s[b + 2] = addp(addp(t, x2), addp(x3, x3));  // x0 + x1 + 2 x2 + 3 x3
    s[b + 3] = addp(addp(t, x3), addp(x0, x0));  // 3 x0 + x1 + x2 + 2 x3
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t total = addp(addp(s[i], s[4 + i]), addp(s[8 + i], s[12 + i]));
#pragma unroll
    for (int b = 0; b < WIDTH; b += 4) s[b + i] = addp(s[b + i], total);
  }
}

__device__ __forceinline__ void external_round(uint32_t s[WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = sbox7(addp(s[i], C[r * WIDTH + i]));
  external_linear(s);
}

__device__ __forceinline__ void permute(uint32_t s[WIDTH]) {
  external_linear(s);
#pragma unroll
  for (int r = 0; r < HALF_EXTERNAL; ++r) external_round(s, r);
#pragma unroll
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
#pragma unroll
  for (int r = HALF_EXTERNAL; r < 2 * HALF_EXTERNAL; ++r) external_round(s, r);
}

__global__ void __launch_bounds__(THREADS)
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
      uint32_t w = base + i < n_words ? row[base + i] : 0u;
      // any u32 mod p: 2p < 2^32 < 3p, so two conditional subtractions
      w = w >= P ? w - P : w;
      w = w >= P ? w - P : w;
      s[i] = addp(s[i], mulp(w, R2));  // to Montgomery form, absorb
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
