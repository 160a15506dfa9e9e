// The memory op log routed to the CPU chip's three memory channels in one
// forward pass (counterpart of chips/cpu.py's `CpuChip._channels_plain`,
// op for op).
//
// The ops are in execution order (clk nondecreasing, a clk's ops in the
// order they ran), so a read's rank among its clk's reads is a counter
// that restarts at each new clk: no search and no sort.
//
// C ABI only (consumed via ctypes, valida_tpu_torch/native/__init__.py).

#include <cstddef>
#include <cstdint>

namespace {

// Whether the ops' clks are nondecreasing and below n (so below the CPU
// log's length).  A loop of its own, which the compiler vectorizes, keeps
// the checks out of the routing pass.
bool clks_in_order(const uint32_t* clk, size_t m, size_t n) {
  if (m == 0) return true;
  bool bad = false;
  for (size_t i = 1; i < m; ++i) bad |= clk[i] < clk[i - 1];
  return !bad && clk[m - 1] < n;
}

}  // namespace

extern "C" {

// clk, is_write, addr, value: m ops in execution order.  left_imm: n
// flags, one a CPU op (its clk).  out: 9 rows of m words, channel ch's
// clk, addr and value in rows 3 ch, 3 ch + 1 and 3 ch + 2, in op order; a
// write goes to channel 2, a clk's first read to channel 0 (1 if its op is
// a left-immediate bus op), its second read to channel 1, later reads
// nowhere.  counts: the three channels' lengths.  Returns 0, or 1 (and
// writes nothing) if a clk decreases or lies at or beyond n.
int mem_cpu_channels(const uint32_t* clk, const uint8_t* is_write,
                     const uint32_t* addr, const uint32_t* value, size_t m,
                     const uint8_t* left_imm, size_t n, uint32_t* out,
                     uint64_t* counts) {
  if (!clks_in_order(clk, m, n)) return 1;
  // the channels' next rows, counted in registers (a count in memory,
  // indexed by the channel, would chain each op to the one before it)
  size_t k0 = 0, k1 = 0, k2 = 0;
  uint32_t prev = m ? clk[0] : 0;
  size_t reads = 0;  // the reads before this op at its clk
  for (size_t i = 0; i < m; ++i) {
    const uint32_t c = clk[i];
    if (c != prev) {
      prev = c;
      reads = 0;
    }
    size_t ch, k;
    if (is_write[i]) {
      ch = 2, k = k2++;
    } else {
      const size_t rank = reads++;
      if (rank == 0 && !left_imm[c]) {
        ch = 0, k = k0++;
      } else if (rank <= 1) {
        ch = 1, k = k1++;
      } else {
        continue;
      }
    }
    uint32_t* row = out + 3 * ch * m + k;
    row[0] = c;
    row[m] = addr[i];
    row[2 * m] = value[i];
  }
  counts[0] = k0, counts[1] = k1, counts[2] = k2;
  return 0;
}

}  // extern "C"
