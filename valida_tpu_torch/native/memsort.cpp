// The memory chip's sorted trace rows and the range bus's counts of their
// sort-delta limbs, in one call (counterpart of chips/memory.py's
// `_sorted_rows`, `_sort_deltas` and `_limb_counts`, row for row and bin
// for bin).
//
// The rows are the static cells (clk 0) followed by the ops in execution
// order (clk nondecreasing).  A stable sort on the address alone therefore
// gives the order of the plain version's sort on (addr, clk, static
// first): at one address the static cell comes first and the ops keep
// their order.  (Ops out of clk order at one address give a negative
// phase-weighted delta, which the sweep rejects.)
//
// The sort is an LSD radix sort of the address less the smallest one, in
// as few digits of at most 11 bits as its span needs (a program's cells lie
// close together: one digit in the benchmark's guests), carrying the row
// index; its last pass writes the rows in place.  One sweep then checks
// each delta and counts its limbs.
//
// C ABI only (consumed via ctypes, valida_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <memory>
#include <utility>
#include <vector>

namespace {

// kind codes of the rows (chips/memory.py)
constexpr uint32_t DUMMY = 0, READ = 1, STATIC = 3;
constexpr int64_t RANGE = int64_t(1) << 30;
constexpr int MAX_DIGIT_BITS = 11;

// phase = 1 - is_read - 2 * is_static: static -1 < read 0 < write, dummy +1
inline int64_t phase(uint32_t kind) {
  return 1 - int64_t(kind == READ) - 2 * int64_t(kind == STATIC);
}

struct Log {
  const uint32_t *static_addr, *static_value;
  size_t n_static;
  const uint32_t* clk;
  const uint8_t* is_write;
  const uint32_t *addr, *value;

  uint32_t address(size_t row) const {
    return row < n_static ? static_addr[row] : addr[row - n_static];
  }
};

struct Rows {
  uint32_t *clk, *kind, *addr, *value;

  void put(size_t i, const Log& log, size_t row) {
    // the scatter writes one stream a cell and column, too many for the
    // hardware's prefetchers: fetch each stream's next line ahead
    if (i % 16 == 0) {
      __builtin_prefetch(clk + i + 16, 1);
      __builtin_prefetch(kind + i + 16, 1);
      __builtin_prefetch(addr + i + 16, 1);
      __builtin_prefetch(value + i + 16, 1);
    }
    if (row < log.n_static) {
      clk[i] = 0;
      kind[i] = STATIC;
      addr[i] = log.static_addr[row];
      value[i] = log.static_value[row];
    } else {
      const size_t j = row - log.n_static;
      clk[i] = log.clk[j];
      kind[i] = READ + log.is_write[j];
      addr[i] = log.addr[j];
      value[i] = log.value[j];
    }
  }
};

// One counting pass of digit (key >> shift) & mask: FIRST reads the rows
// in their numbering, else the (key << 32 | row) entries of `from`; LAST
// writes the rows, else entries into `to`.
template <bool FIRST, bool LAST>
void scatter(const Log& log, uint32_t lo, size_t n, int shift, uint32_t mask,
             std::vector<size_t>& offset, const uint64_t* from, uint64_t* to,
             Rows& rows) {
  for (size_t i = 0; i < n; ++i) {
    const uint64_t e =
        FIRST ? uint64_t(log.address(i) - lo) << 32 | i : from[i];
    const size_t pos = offset[(e >> (32 + shift)) & mask]++;
    if (LAST) {
      rows.put(pos, log, uint32_t(e));
    } else {
      to[pos] = e;
    }
  }
}

// the range bus's messages of one delta below 2^30: its three low bytes
// and 4 times its top byte (below 64).  Counts those that are not 0 and
// returns the number of the others (the caller sums them: bin 0 is hit
// by most rows).
inline uint64_t count_limbs(uint64_t* counts, uint64_t d) {
  if (d < 256) {
    if (d == 0) return 4;
    ++counts[d];
    return 3;
  }
  const uint64_t limbs[4] = {d & 0xFF, (d >> 8) & 0xFF, (d >> 16) & 0xFF,
                             4 * ((d >> 24) & 0xFF)};
  uint64_t zeros = 0;
  for (uint64_t limb : limbs) {
    if (limb == 0) {
      ++zeros;
    } else {
      ++counts[limb];
    }
  }
  return zeros;
}

}  // namespace

extern "C" {

// static_addr, static_value: n_static cells (distinct addresses).  clk,
// is_write, addr, value: n_ops ops in execution order.  rows: 4 * n2
// words, written as four columns of n2 (clk, kind, addr, value), n2 the
// power of two at or above n_static + n_ops (1 when that is 0); rows past
// the last are dummies (kind 0) repeating its clk, addr and value.
// counts: 256 words, incremented by the limbs of every transition's delta
// and by the last row's four zero limbs.  Returns 0, or 1 if a delta lies
// outside [0, 2^30) (rows and counts are then partly written).
int mem_sort_rows(const uint32_t* static_addr, const uint32_t* static_value,
                  size_t n_static, const uint32_t* clk,
                  const uint8_t* is_write, const uint32_t* addr,
                  const uint32_t* value, size_t n_ops, uint32_t* rows,
                  size_t n2, uint64_t* counts) {
  const Log log{static_addr, static_value, n_static, clk,
                is_write,    addr,         value};
  Rows out{rows, rows + n2, rows + 2 * n2, rows + 3 * n2};
  const size_t n = n_static + n_ops;
  if (n == 0) {
    out.clk[0] = out.kind[0] = out.addr[0] = out.value[0] = 0;
    counts[0] += 4;
    return 0;
  }

  uint32_t lo = log.address(0), hi = lo;
  for (size_t i = 0; i < n_static; ++i) {
    lo = std::min(lo, static_addr[i]);
    hi = std::max(hi, static_addr[i]);
  }
  for (size_t i = 0; i < n_ops; ++i) {
    lo = std::min(lo, addr[i]);
    hi = std::max(hi, addr[i]);
  }
  int bits = 0;
  while (bits < 32 && (hi - lo) >> bits) ++bits;
  const int passes =
      std::max(1, (bits + MAX_DIGIT_BITS - 1) / MAX_DIGIT_BITS);
  const int width = (bits + passes - 1) / passes;
  const uint32_t mask = (uint32_t(1) << width) - 1;
  std::vector<std::vector<size_t>> offset(
      passes, std::vector<size_t>(size_t(1) << width));
  for (size_t i = 0; i < n; ++i) {
    const uint32_t key = log.address(i) - lo;
    for (int p = 0; p < passes; ++p) ++offset[p][(key >> (p * width)) & mask];
  }
  for (auto& o : offset) {
    size_t sum = 0;
    for (auto& c : o) sum += std::exchange(c, sum);
  }
  if (passes == 1) {
    scatter<true, true>(log, lo, n, 0, mask, offset[0], nullptr, nullptr,
                        out);
  } else {
    std::unique_ptr<uint64_t[]> a(new uint64_t[n]), b(new uint64_t[n]);
    scatter<true, false>(log, lo, n, 0, mask, offset[0], nullptr, a.get(),
                         out);
    for (int p = 1; p < passes - 1; ++p) {
      scatter<false, false>(log, lo, n, p * width, mask, offset[p], a.get(),
                            b.get(), out);
      std::swap(a, b);
    }
    scatter<false, true>(log, lo, n, (passes - 1) * width, mask,
                         offset[passes - 1], a.get(), nullptr, out);
  }

  int64_t prev_phase = phase(out.kind[0]);
  uint64_t zeros = 4;  // the last row: no transition, zero limbs
  for (size_t i = 1; i < n; ++i) {
    const int64_t ph = phase(out.kind[i]);
    const int64_t diff =
        out.addr[i] != out.addr[i - 1]
            ? int64_t(out.addr[i]) - out.addr[i - 1]
            : 2 * (int64_t(out.clk[i]) - out.clk[i - 1]) + ph - prev_phase;
    if (diff < 0 || diff >= RANGE) return 1;
    zeros += count_limbs(counts, uint64_t(diff));
    prev_phase = ph;
  }
  // the padding: dummies (phase +1) repeating the last row, so a delta of
  // 1 - its phase into the first and 0 between them
  for (size_t i = n; i < n2; ++i) {
    out.clk[i] = out.clk[n - 1];
    out.kind[i] = DUMMY;
    out.addr[i] = out.addr[n - 1];
    out.value[i] = out.value[n - 1];
  }
  if (n2 > n) {
    zeros += count_limbs(counts, uint64_t(phase(DUMMY) - prev_phase));
    zeros += 4 * (n2 - n - 1);
  }
  counts[0] += zeros;
  return 0;
}

}  // extern "C"
