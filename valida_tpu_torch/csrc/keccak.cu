// Batched Keccak-256 (original 0x01 padding, rate 136 bytes) of u32-word
// messages: words u32 [batch, n_words] -> digests u32 [batch, 8].
//
// Replaces valida_tpu/crypto/keccak.py::_keccak_pallas.  The TPU kernel
// splits every 64-bit lane into (lo, hi) u32 halves, because the TPU has no
// 64-bit integers, and transposes the batch into vector lanes.  Here one
// thread hashes one message, with the 25 lanes as native uint64_t in
// registers; lane k of a block is word[2k] | word[2k+1] << 32.  Absorption
// runs on chip over n_words / 34 + 1 blocks, the padding applied as the
// words are read, so device memory sees one read of the message and one
// write of the digest.
//
// What bounds it: the integer/logic units.  Each block is one Keccak-f of
// 24 rounds of about 130 64-bit operations (xor, and-not, rotate), some
// 2,900 operations per 136-byte block, well above the card's ratio of
// integer operations to memory bytes.  The message rows are read with a
// stride of n_words words between neighbouring threads, which does not
// coalesce; staging rows through shared memory is left to a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RATE_WORDS = 34;
constexpr int THREADS = 128;

__constant__ uint64_t RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return r == 0 ? x : (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ void keccak_f(uint64_t a[25]) {
#pragma unroll 1
  for (int rnd = 0; rnd < 24; ++rnd) {
    uint64_t c[5], d[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
    for (int i = 0; i < 25; ++i) a[i] ^= d[i % 5];
    // rho + pi: lane x + 5y moves to y + 5((2x + 3y) mod 5), rotated
    b[0] = rotl64(a[0], 0); b[10] = rotl64(a[1], 1); b[20] = rotl64(a[2], 62);
    b[5] = rotl64(a[3], 28); b[15] = rotl64(a[4], 27); b[16] = rotl64(a[5], 36);
    b[1] = rotl64(a[6], 44); b[11] = rotl64(a[7], 6); b[21] = rotl64(a[8], 55);
    b[6] = rotl64(a[9], 20); b[7] = rotl64(a[10], 3); b[17] = rotl64(a[11], 10);
    b[2] = rotl64(a[12], 43); b[12] = rotl64(a[13], 25); b[22] = rotl64(a[14], 39);
    b[23] = rotl64(a[15], 41); b[8] = rotl64(a[16], 45); b[18] = rotl64(a[17], 15);
    b[3] = rotl64(a[18], 21); b[13] = rotl64(a[19], 8); b[14] = rotl64(a[20], 18);
    b[24] = rotl64(a[21], 2); b[9] = rotl64(a[22], 61); b[19] = rotl64(a[23], 56);
    b[4] = rotl64(a[24], 14);
    // chi
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
    }
    a[0] ^= RC[rnd];  // iota
  }
}

__global__ void __launch_bounds__(THREADS)
keccak256_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ out,
                 int batch, int n_words) {
  const int msg = blockIdx.x * THREADS + threadIdx.x;
  if (msg >= batch) return;
  const uint32_t* row = words + (size_t)msg * n_words;
  const int n_blocks = n_words / RATE_WORDS + 1;
  const int last = n_blocks * RATE_WORDS - 1;
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) a[i] = 0;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int base = blk * RATE_WORDS;
#pragma unroll
    for (int k = 0; k < RATE_WORDS / 2; ++k) {
      uint32_t w[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = base + 2 * k + h;
        uint32_t v = g < n_words ? row[g] : 0u;
        if (g == n_words) v ^= 0x01u;         // first padding byte
        if (g == last) v ^= 0x80000000u;      // final 0x80 byte
        w[h] = v;
      }
      a[k] ^= (uint64_t)w[0] | ((uint64_t)w[1] << 32);
    }
    keccak_f(a);
  }
  uint32_t* o = out + (size_t)msg * 8;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[2 * k] = (uint32_t)a[k];
    o[2 * k + 1] = (uint32_t)(a[k] >> 32);
  }
}

}  // namespace

extern "C" int keccak256_launch(const void* words, void* out, int batch,
                                int n_words, void* stream) {
  const int grid = (batch + THREADS - 1) / THREADS;
  keccak256_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (uint32_t*)out, batch, n_words);
  return (int)cudaGetLastError();
}
