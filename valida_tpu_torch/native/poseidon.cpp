// The Fiat-Shamir challenger's Poseidon permutation over BabyBear, width 16,
// alpha = 5 (counterpart of crypto/poseidon.py's `permute_host_plain`, word
// for word).
//
// 4 full rounds, 22 partial rounds, 4 full rounds; each adds the round's
// constants, raises every lane (a full round) or lane 0 (a partial round)
// to the fifth power and multiplies by the 16 x 16 MDS matrix.  The
// constants are the caller's: the active parameter set's canonical words,
// handed over on every call.  All arithmetic is exact mod p on 64-bit
// words.
//
// C ABI only (consumed via ctypes, valida_tpu_torch/crypto/poseidon.py).

#include <cstdint>

namespace {

constexpr uint64_t P = 2013265921;  // 2^31 - 2^27 + 1
constexpr int WIDTH = 16;
constexpr int HALF_FULL_ROUNDS = 4;
constexpr int PARTIAL_ROUNDS = 22;
constexpr int NUM_ROUNDS = 2 * HALF_FULL_ROUNDS + PARTIAL_ROUNDS;

inline uint64_t sbox(uint64_t x) {
  uint64_t x2 = x * x % P;
  uint64_t x4 = x2 * x2 % P;
  return x4 * x % P;
}

}  // namespace

extern "C" {

// state: 16 words, reduced mod p first, permuted in place.  rc: [30, 16]
// round constants and mds: [16, 16], row-major, every word below p.
void poseidon16_permute(uint64_t* state, const uint64_t* rc,
                        const uint64_t* mds) {
  uint64_t s[WIDTH], t[WIDTH];
  for (int i = 0; i < WIDTH; ++i) s[i] = state[i] % P;
  for (int r = 0; r < NUM_ROUNDS; ++r) {
    const uint64_t* c = rc + r * WIDTH;
    for (int i = 0; i < WIDTH; ++i) s[i] = (s[i] + c[i]) % P;
    if (r >= HALF_FULL_ROUNDS && r < HALF_FULL_ROUNDS + PARTIAL_ROUNDS) {
      s[0] = sbox(s[0]);
    } else {
      for (int i = 0; i < WIDTH; ++i) s[i] = sbox(s[i]);
    }
    for (int i = 0; i < WIDTH; ++i) {
      const uint64_t* m = mds + i * WIDTH;
      // four products below p^2 < 2^62 sum below 2^64
      uint64_t acc = 0;
      for (int j = 0; j < WIDTH; j += 4) {
        acc += (m[j] * s[j] + m[j + 1] * s[j + 1] + m[j + 2] * s[j + 2] +
                m[j + 3] * s[j + 3]) % P;
      }
      t[i] = acc % P;
    }
    for (int i = 0; i < WIDTH; ++i) s[i] = t[i];
  }
  for (int i = 0; i < WIDTH; ++i) state[i] = s[i];
}

}  // extern "C"
