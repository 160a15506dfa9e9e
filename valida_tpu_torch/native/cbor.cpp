// The CBOR writer of proof serialization (counterpart of the word loop of
// tooling/serde.py's scalar encoder, byte for byte).
//
// The caller walks its object once and hands over a skeleton: the bytes of
// every head, key and scalar, with a mark at each place where a uint32
// array goes.  This pass copies the skeleton and writes each array there:
// an array of shape [d0, d1, ..., dk] becomes a CBOR array of d0 items,
// each the array of shape [d1, ..., dk], down to unsigned ints, every head
// in its shortest form (1, 2, 3 or 5 bytes for a word, up to 9 for a
// length).  One pass writes it, into a buffer the caller sizes by the
// most the arrays' shapes can take.  The arrays' words come flattened, one after another, in the
// order of their marks.
//
// C ABI only (consumed via ctypes, valida_tpu_torch/tooling/serde.py).

#include <cstdint>
#include <cstring>

namespace {

inline uint8_t* put_head(uint8_t* o, uint8_t major, uint64_t v) {
  const uint8_t m = static_cast<uint8_t>(major << 5);
  if (v < 24) {
    *o++ = m | static_cast<uint8_t>(v);
  } else if (v < 0x100) {
    *o++ = m | 24;
    *o++ = static_cast<uint8_t>(v);
  } else if (v < 0x10000) {
    *o++ = m | 25;
    *o++ = static_cast<uint8_t>(v >> 8);
    *o++ = static_cast<uint8_t>(v);
  } else if (v < 0x100000000ull) {
    *o++ = m | 26;
    for (int s = 24; s >= 0; s -= 8) *o++ = static_cast<uint8_t>(v >> s);
  } else {
    *o++ = m | 27;
    for (int s = 56; s >= 0; s -= 8) *o++ = static_cast<uint8_t>(v >> s);
  }
  return o;
}

// One unsigned int below 2^32 in its shortest head.  A field word or a
// digest word is almost always 2^16 or above: that case comes first.
inline uint8_t* put_word(uint8_t* o, uint32_t v) {
  if (v >= 0x10000) {
    o[0] = 26;
    o[1] = static_cast<uint8_t>(v >> 24);
    o[2] = static_cast<uint8_t>(v >> 16);
    o[3] = static_cast<uint8_t>(v >> 8);
    o[4] = static_cast<uint8_t>(v);
    return o + 5;
  }
  if (v < 24) {
    o[0] = static_cast<uint8_t>(v);
    return o + 1;
  }
  if (v < 0x100) {
    o[0] = 24;
    o[1] = static_cast<uint8_t>(v);
    return o + 2;
  }
  o[0] = 25;
  o[1] = static_cast<uint8_t>(v >> 8);
  o[2] = static_cast<uint8_t>(v);
  return o + 3;
}

// Words of the array of shape dims[0..nd).
uint64_t word_count(const int64_t* dims, int64_t nd) {
  uint64_t n = 1;
  for (int64_t j = 0; j < nd; ++j) n *= static_cast<uint64_t>(dims[j]);
  return n;
}

// The most bytes the array of shape dims[0..nd) can take: 9 a length
// head, 5 a word.
uint64_t leaf_bound(const int64_t* dims, int64_t nd) {
  uint64_t heads = 0, items = 1;
  for (int64_t j = 0; j + 1 < nd; ++j) {
    heads += items;
    items *= static_cast<uint64_t>(dims[j]);
  }
  return 9 * (heads + items) + 5 * items * static_cast<uint64_t>(dims[nd - 1]);
}

uint8_t* put_leaf(uint8_t* o, const int64_t* dims, int64_t nd,
                  const uint32_t* w) {
  const uint64_t d0 = static_cast<uint64_t>(dims[0]);
  o = put_head(o, 4, d0);
  if (nd == 1) {
    for (uint64_t i = 0; i < d0; ++i) o = put_word(o, w[i]);
  } else {
    const uint64_t step = word_count(dims + 1, nd - 1);
    for (uint64_t i = 0; i < d0; ++i)
      o = put_leaf(o, dims + 1, nd - 1, w + i * step);
  }
  return o;
}

}  // namespace

extern "C" {

// skel: n_skel skeleton bytes.  marks: n_leaves offsets into skel,
// nondecreasing, each at most n_skel: leaf i is written where the skeleton
// reaches marks[i].  dims: per leaf its ndim (at least 1) and then its
// dimensions, n_dims values in all.  words: the n_words words of every
// leaf, flattened in order.  Writes into out (cap bytes) and sets *size.
// Returns 0 when written (*size: the bytes written); 1 when cap is below
// the most the encoding can take (*size: that bound; nothing is written);
// 2 when the layout is inconsistent.
int cbor_write(const uint8_t* skel, size_t n_skel, const int64_t* marks,
               size_t n_leaves, const int64_t* dims, size_t n_dims,
               const uint32_t* words, size_t n_words, uint8_t* out,
               size_t cap, size_t* size) {
  // check the layout and bound the output, from the dims alone
  uint64_t bound = n_skel, used = 0;
  size_t d = 0;
  int64_t prev = 0;
  for (size_t i = 0; i < n_leaves; ++i) {
    if (marks[i] < prev || static_cast<size_t>(marks[i]) > n_skel) return 2;
    prev = marks[i];
    if (d >= n_dims) return 2;
    const int64_t nd = dims[d];
    if (nd < 1 || static_cast<uint64_t>(nd) > n_dims - d - 1) return 2;
    for (int64_t j = 0; j < nd; ++j) {
      if (dims[d + 1 + j] < 0) return 2;
    }
    const uint64_t count = word_count(dims + d + 1, nd);
    if (count > n_words - used) return 2;
    bound += leaf_bound(dims + d + 1, nd);
    used += count;
    d += 1 + static_cast<size_t>(nd);
  }
  if (d != n_dims || used != n_words) return 2;
  if (bound > cap) {
    *size = bound;
    return 1;
  }
  // the skeleton with every leaf in its place
  uint8_t* o = out;
  size_t at = 0;
  d = 0;
  used = 0;
  for (size_t i = 0; i < n_leaves; ++i) {
    const size_t m = static_cast<size_t>(marks[i]);
    std::memcpy(o, skel + at, m - at);
    o += m - at;
    at = m;
    const int64_t nd = dims[d];
    o = put_leaf(o, dims + d + 1, nd, words + used);
    used += word_count(dims + d + 1, nd);
    d += 1 + static_cast<size_t>(nd);
  }
  std::memcpy(o, skel + at, n_skel - at);
  o += n_skel - at;
  *size = static_cast<size_t>(o - out);
  return 0;
}

}  // extern "C"
