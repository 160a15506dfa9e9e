// Native VM interpreter core of valida_tpu_torch (counterpart of
// valida_tpu/native/interpreter.cpp: the same semantics and C ABI).
//
// Executes a program ROM with the exact semantics of the Python interpreter
// (valida_tpu_torch/chips/cpu.py, alu.py, output.py, which mirror the Rust
// reference's execute impls), recording the per-chip operation logs as flat
// arrays that are copied out into numpy.  The sequential step loop is the
// one part of the prover that stays on the host; this replaces the Python
// step loop, and its arrays feed the trace builders with no Python walk
// over the logs.
//
// C ABI only (consumed via ctypes, valida_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t LOAD32 = 1, STORE32 = 2, JAL = 3, JALV = 4, BEQ = 5,
                   BNE = 6, IMM32 = 7, STOP = 8, READ_ADVICE = 9, LOADFP = 10,
                   LOADU8 = 11, LOADS8 = 12, STOREU8 = 13;
constexpr uint32_t ADD32 = 100, SUB32 = 101, MUL32 = 102, DIV32 = 103,
                   LT32 = 104, SHL32 = 105, SHR32 = 106, AND32 = 107,
                   OR32 = 108, XOR32 = 109, SDIV32 = 110, NE32 = 111,
                   MULHU32 = 112, SRA32 = 113, MULHS32 = 114, LTE32 = 115,
                   EQ32 = 116, SLT32 = 117, SLE32 = 118;
constexpr uint32_t FADD = 200, FSUB = 201, FMUL = 202, WRITE = 300;
constexpr uint32_t BYTES_PER_INSTR = 24;
constexpr uint64_t FIELD_P = 2013265921;

// cpu op kinds (shared with native/__init__.py and chips/cpu.py)
enum CpuKind : uint8_t {
  K_LOAD = 0, K_LOAD_U8, K_LOAD_S8, K_STORE, K_STORE_U8, K_JAL, K_JALV,
  K_BEQ, K_BNE, K_IMM32, K_ADVICE, K_STOP, K_LOADFP, K_BUS, K_BUS_LEFT_IMM,
  K_BUS_WITH_MEMORY
};

struct Instruction {
  uint32_t opcode;
  int32_t ops[5];
};

struct CpuOp {
  uint8_t kind;
  uint8_t has_imm;
  uint32_t imm;
  uint32_t opcode;
  int32_t operands[5];
  uint32_t pc;  // pre-execution register snapshot
  uint32_t fp;
};

struct MemOp {
  uint32_t clk;
  uint8_t is_write;
  uint32_t addr;
  uint32_t value;
};

struct AluOp {  // generic (kind, a, b, c) record
  uint32_t kind;
  uint32_t a, b, c;
};

struct Vm {
  std::vector<Instruction> rom;
  std::unordered_map<uint32_t, uint32_t> cells;
  const uint8_t* advice = nullptr;
  size_t advice_len = 0, advice_pos = 0;

  uint32_t pc = 0, fp = 0;
  uint64_t clock = 0;
  bool stopped = false;
  std::string error;

  std::vector<CpuOp> cpu_ops;
  std::vector<MemOp> mem_ops;
  std::vector<AluOp> add_ops, sub_ops, mul_ops, div_ops, lt_ops, com_ops,
      bitwise_ops, shift_ops, nf_ops;
  std::vector<uint32_t> range_count = std::vector<uint32_t>(256, 0);
  std::vector<uint32_t> program_counts;
  std::vector<uint64_t> output_clk;
  std::vector<uint32_t> output_val;

  bool fail(const std::string& msg) {
    error = msg;
    return false;
  }

  // a read of an address already written at this clk is unprovable under
  // the phase-ordered memory argument (chips/memory.py docstring); fail
  // at execute time with a clear error — keep in lockstep with
  // MemoryChip._check_same_clk_raw
  bool same_clk_write(uint32_t addr) {
    for (auto it = mem_ops.rbegin();
         it != mem_ops.rend() && it->clk == (uint32_t)clock; ++it)
      if (it->is_write && it->addr == addr) return true;
    return false;
  }

  bool mem_read(uint32_t addr, uint32_t* out, uint32_t opcode, int ordinal) {
    auto it = cells.find(addr);
    if (it == cells.end()) {
      return fail("memory chip: read before write: " + std::to_string(addr) +
                  " (pc = " + std::to_string(pc) +
                  ", opcode = " + std::to_string(opcode) +
                  ", ordinal = " + std::to_string(ordinal) + ")");
    }
    if (same_clk_write(addr)) {
      return fail("memory chip: read of " + std::to_string(addr) +
                  " after a same-clk write (clk = " + std::to_string(clock) +
                  ", pc = " + std::to_string(pc) +
                  ", opcode = " + std::to_string(opcode) + ")");
    }
    *out = it->second;
    mem_ops.push_back({(uint32_t)clock, 0, addr, it->second});
    return true;
  }

  uint32_t mem_read_or_init(uint32_t addr) {
    auto it = cells.find(addr);
    uint32_t v = it == cells.end() ? 0 : it->second;
    mem_ops.push_back({(uint32_t)clock, 0, addr, v});
    return v;
  }

  // unlogged read (mirrors chips/memory.py::peek)
  uint32_t mem_peek(uint32_t addr) {
    auto it = cells.find(addr);
    return it == cells.end() ? 0 : it->second;
  }

  void mem_write(uint32_t addr, uint32_t value) {
    mem_ops.push_back({(uint32_t)clock, 1, addr, value});
    cells[addr] = value;
  }

  void push_op(CpuKind kind, bool has_imm, uint32_t imm,
               const Instruction& iw) {
    CpuOp op;
    op.kind = kind;
    op.has_imm = has_imm;
    op.imm = imm;
    op.opcode = iw.opcode;
    std::memcpy(op.operands, iw.ops, sizeof(iw.ops));
    op.pc = pc;
    op.fp = fp;
    cpu_ops.push_back(op);
    clock += 1;
  }

  void range_check(uint32_t value) {
    range_count[(value >> 24) & 0xFF]++;
    range_count[(value >> 16) & 0xFF]++;
    range_count[(value >> 8) & 0xFF]++;
    range_count[value & 0xFF]++;
  }

  // mirrors chips/byte.py::register_range_checks (alignment decomposition
  // limbs + the sign byte for the byte chip's range-bus sends)
  bool byte_range_checks(uint32_t src_al, uint32_t dst_al, uint8_t sel) {
    const uint32_t als[2] = {src_al, dst_al};
    for (uint32_t al : als) {
      if (al >> 30)
        return fail("byte op address outside the 2^30 byte space: " +
                    std::to_string(al));
      uint32_t q = al >> 2;
      range_count[q & 0xFF]++;
      range_count[(q >> 8) & 0xFF]++;
      range_count[(q >> 16) & 0xFF]++;
      range_count[(16 * (q >> 24)) & 0xFF]++;
    }
    range_count[2 * (sel & 0x7F)]++;
    return true;
  }

  // witness bookkeeping for an unsigned-division row (mirrors
  // chips/alu.py::_div_side_effects)
  void div_side_effects(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r = b - a * c;
    range_check(r);
    int64_t a0 = a & 0xFF, a1 = (a >> 8) & 0xFF, a2 = (a >> 16) & 0xFF;
    int64_t c0 = c & 0xFF, c1 = (c >> 8) & 0xFF, c2 = (c >> 16) & 0xFF;
    int64_t b0 = b & 0xFF, b1 = (b >> 8) & 0xFF, b2 = (b >> 16) & 0xFF;
    int64_t r0 = r & 0xFF, r1 = (r >> 8) & 0xFF, r2 = (r >> 16) & 0xFF;
    int64_t t0 = (a0 * c0 + r0 - b0) / 256;
    int64_t t1 = (a0 * c1 + a1 * c0 + r1 + t0 - b1) / 256;
    int64_t t2 = (a0 * c2 + a1 * c1 + a2 * c0 + r2 + t1 - b2) / 256;
    range_count[t0 & 0xFF]++;
    range_count[t1 & 0xFF]++;
    range_count[t2 & 0xFF]++;
    lt_ops.push_back({0, 1, r, c});
  }

  // mirrors chips/alu.py::_sdiv_side_effects
  void sdiv_side_effects(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t sb = b >> 31, sc = c >> 31;
    uint32_t nb = sb ? (uint32_t)(0u - b) : b;
    uint32_t nc = sc ? (uint32_t)(0u - c) : c;
    uint32_t na = nb / nc;
    if (sb) {
      sub_ops.push_back({0, nb, 0, b});
      range_check(nb);
    }
    if (sc) {
      sub_ops.push_back({0, nc, 0, c});
      range_check(nc);
    }
    if (sb != sc) {
      sub_ops.push_back({0, a, 0, na});
      range_check(a);
      range_check(na);
    }
    div_side_effects(na, nb, nc);
  }

  // mirrors chips/alu.py::_mulh_side_effects
  void mulh_side_effects(uint32_t kind, uint32_t b, uint32_t c) {
    uint64_t p = (uint64_t)b * (uint64_t)c;
    range_check((uint32_t)p);
    if (kind == 1) range_check((uint32_t)(p >> 32));
    int64_t bl[4], cl[4];
    for (int i = 0; i < 4; i++) {
      bl[i] = (b >> (8 * i)) & 0xFF;
      cl[i] = (c >> (8 * i)) & 0xFF;
    }
    int64_t t = 0;
    for (int k = 0; k < 7; k++) {
      int64_t pk = 0;
      int lo_x = k - 3 > 0 ? k - 3 : 0, hi_x = k < 3 ? k : 3;
      for (int x = lo_x; x <= hi_x; x++) pk += bl[x] * cl[k - x];
      t = (pk + t - (int64_t)((p >> (8 * k)) & 0xFF)) >> 8;
      range_count[t & 0xFF]++;
    }
  }

  // ---- operand fetch shared by ALU ops ----
  bool read_b_c(const Instruction& iw, bool left_imm_allowed, uint32_t opc,
                uint32_t* b, uint32_t* c, bool* has_imm, uint32_t* imm,
                bool* left_imm) {
    *has_imm = false;
    *left_imm = false;
    if (left_imm_allowed && iw.ops[3] == 1) {
      *b = (uint32_t)iw.ops[1];
      *imm = *b;
      *has_imm = true;
      *left_imm = true;
    } else {
      if (!mem_read(fp + (uint32_t)iw.ops[1], b, opc, 0)) return false;
    }
    if (iw.ops[4] == 1) {
      *c = (uint32_t)iw.ops[2];
      *imm = *c;
      *has_imm = true;
    } else {
      if (!mem_read(fp + (uint32_t)iw.ops[2], c, opc, 1)) return false;
    }
    return true;
  }

  void finish_alu(const Instruction& iw, uint32_t a, bool has_imm,
                  uint32_t imm, bool left_imm, bool do_range) {
    mem_write(fp + (uint32_t)iw.ops[0], a);
    pc += 1;
    push_op(left_imm ? K_BUS_LEFT_IMM : K_BUS, has_imm, imm, iw);
    if (do_range) range_check(a);
  }

  bool step() {
    if (pc >= rom.size()) return fail("pc out of bounds");
    const Instruction iw = rom[pc];
    const uint32_t opc = iw.opcode;
    uint32_t b, c, v;
    bool has_imm, left_imm;
    uint32_t imm = 0;

    switch (opc) {
      case LOAD32: {
        uint32_t ra1 = fp + (uint32_t)iw.ops[2];
        if (ra1 % 4) return fail("LOAD32: read address location misaligned");
        uint32_t ra2;
        if (!mem_read(ra1, &ra2, opc, 0)) return false;
        if (ra2 % 4) return fail("LOAD32: read address misaligned");
        uint32_t wa = fp + (uint32_t)iw.ops[0];
        if (wa % 4) return fail("LOAD32: write address misaligned");
        if (!mem_read(ra2, &v, opc, 1)) return false;
        mem_write(wa, v);
        pc += 1;
        push_op(K_LOAD, false, 0, iw);
        break;
      }
      case LOADU8:
      case LOADS8: {
        uint32_t ra_loc = fp + (uint32_t)iw.ops[2];
        uint32_t ra;
        if (!mem_read(ra_loc, &ra, opc, 0)) return false;
        uint32_t cell;
        if (!mem_read(ra & ~3u, &cell, opc, 1)) return false;
        // index_of_byte(ra) = 3 - (ra & 3); BE slot i holds value bits
        // (3-i)*8.. -> slot 3-(ra&3) holds bits (ra&3)*8..
        uint8_t byte = (cell >> (8 * (ra & 3))) & 0xFF;
        uint32_t out =
            opc == LOADU8
                ? byte
                : ((byte & 0x80) ? (0xFFFFFF00u | byte) : (uint32_t)byte);
        uint32_t wa = (fp + (uint32_t)iw.ops[0]) & ~3u;
        mem_write(wa, out);
        if (!byte_range_checks(ra & ~3u, wa, byte)) return false;
        pc += 1;
        push_op(opc == LOADU8 ? K_LOAD_U8 : K_LOAD_S8, false, 0, iw);
        break;
      }
      case STORE32: {
        // channel 0 = value read at fp+c, channel 1 = target-address cell
        // at fp+b (the AIR's layout, cpu/src/stark.rs:121-122; keep in
        // exact lockstep with chips/cpu.py ex_store32)
        uint32_t ra = fp + (uint32_t)iw.ops[2];
        if (ra % 4) return fail("STORE32: read address misaligned");
        uint32_t wa_loc = fp + (uint32_t)iw.ops[1];
        if (wa_loc % 4) return fail("STORE32: write address location misaligned");
        if (!mem_read(ra, &v, opc, 0)) return false;
        uint32_t wa;
        if (!mem_read(wa_loc, &wa, opc, 1)) return false;
        if (wa % 4) return fail("STORE32: write address misaligned");
        mem_write(wa, v);
        pc += 1;
        push_op(K_STORE, false, 0, iw);
        break;
      }
      case STOREU8: {
        uint32_t ra = fp + (uint32_t)iw.ops[2];
        uint32_t wa_loc = fp + (uint32_t)iw.ops[1];
        uint32_t wa;
        if (!mem_read(wa_loc, &wa, opc, 0)) return false;
        uint32_t cell;
        if (!mem_read(ra & ~3u, &cell, opc, 1)) return false;
        uint8_t byte = (cell >> (8 * (ra & 3))) & 0xFF;
        uint32_t wa_idx = wa & ~3u;
        // logged merge read (read_or_init, cpu/src/lib.rs:687) — proved
        // via the byte chip's memory-bus send
        uint32_t cur = mem_read_or_init(wa_idx);
        // update_byte: byte-swap then write at BE slot index_of_byte(wa)
        uint32_t swapped = __builtin_bswap32(cur);
        uint32_t loc = 3 - (wa & 3);
        uint32_t shift2 = (3 - loc) * 8;
        swapped = (swapped & ~(0xFFu << shift2)) | ((uint32_t)byte << shift2);
        mem_write(wa_idx, swapped);
        if (!byte_range_checks(ra & ~3u, wa_idx, byte)) return false;
        pc += 1;
        push_op(K_STORE_U8, false, 0, iw);
        break;
      }
      case JAL: {
        mem_write(fp + (uint32_t)iw.ops[0], BYTES_PER_INSTR * (pc + 1));
        uint32_t target = (uint32_t)iw.ops[1];
        uint32_t new_fp = fp + (uint32_t)iw.ops[2];
        pc = target / BYTES_PER_INSTR;
        fp = new_fp;
        push_op(K_JAL, false, 0, iw);
        break;
      }
      case JALV: {
        mem_write(fp + (uint32_t)iw.ops[0], BYTES_PER_INSTR * (pc + 1));
        uint32_t target;
        if (!mem_read(fp + (uint32_t)iw.ops[1], &target, opc, 0)) return false;
        uint32_t offset;
        if (!mem_read(fp + (uint32_t)iw.ops[2], &offset, opc, 2)) return false;
        pc = target / BYTES_PER_INSTR;
        fp = fp + offset;
        push_op(K_JALV, false, 0, iw);
        break;
      }
      case BEQ:
      case BNE: {
        uint32_t cell1;
        if (!mem_read(fp + (uint32_t)iw.ops[1], &cell1, opc, 0)) return false;
        uint32_t cell2;
        has_imm = false;
        if (iw.ops[4] == 1) {
          cell2 = (uint32_t)iw.ops[2];
          imm = cell2;
          has_imm = true;
        } else {
          if (!mem_read(fp + (uint32_t)iw.ops[2], &cell2, opc, 1)) return false;
        }
        bool taken = (cell1 == cell2) == (opc == BEQ);
        if (taken) {
          pc = ((uint32_t)iw.ops[0]) / BYTES_PER_INSTR;
        } else {
          pc += 1;
        }
        push_op(opc == BEQ ? K_BEQ : K_BNE, has_imm, imm, iw);
        break;
      }
      case IMM32: {
        uint32_t value = (((uint32_t)iw.ops[1] & 0xFF) << 24) |
                         (((uint32_t)iw.ops[2] & 0xFF) << 16) |
                         (((uint32_t)iw.ops[3] & 0xFF) << 8) |
                         ((uint32_t)iw.ops[4] & 0xFF);
        mem_write(fp + (uint32_t)iw.ops[0], value);
        pc += 1;
        push_op(K_IMM32, false, 0, iw);
        break;
      }
      case STOP:
        push_op(K_STOP, false, 0, iw);
        stopped = true;
        break;
      case READ_ADVICE: {
        uint32_t value = 0xFFFFFFFFu;
        if (advice_pos < advice_len) value = advice[advice_pos++];
        mem_write(fp + (uint32_t)iw.ops[0], value);
        pc += 1;
        push_op(K_ADVICE, false, 0, iw);
        break;
      }
      case LOADFP: {
        mem_write(fp + (uint32_t)iw.ops[0], fp + (uint32_t)iw.ops[1]);
        pc += 1;
        push_op(K_LOADFP, false, 0, iw);
        break;
      }
      case ADD32:
      case SUB32: {
        if (!read_b_c(iw, false, opc, &b, &c, &has_imm, &imm, &left_imm))
          return false;
        uint32_t a = opc == ADD32 ? b + c : b - c;
        (opc == ADD32 ? add_ops : sub_ops).push_back({0, a, b, c});
        finish_alu(iw, a, has_imm, imm, false, true);
        break;
      }
      case MUL32:
      case MULHS32:
      case MULHU32: {
        if (!read_b_c(iw, false, opc, &b, &c, &has_imm, &imm, &left_imm))
          return false;
        uint32_t a, kind;
        if (opc == MUL32) {
          a = b * c;
          kind = 0;
        } else if (opc == MULHS32) {
          a = (uint32_t)(((int64_t)(int32_t)b * (int64_t)(int32_t)c) >> 32);
          kind = 1;
        } else {
          a = (uint32_t)(((uint64_t)b * (uint64_t)c) >> 32);
          kind = 2;
        }
        mul_ops.push_back({kind, a, b, c});
        if (kind != 0) mulh_side_effects(kind, b, c);
        finish_alu(iw, a, has_imm, imm, false, true);
        break;
      }
      case DIV32:
      case SDIV32: {
        if (!read_b_c(iw, false, opc, &b, &c, &has_imm, &imm, &left_imm))
          return false;
        if (c == 0) return fail("division by zero");
        uint32_t a = opc == DIV32 ? b / c
                                  : (uint32_t)((int32_t)b / (int32_t)c);
        div_ops.push_back({opc == DIV32 ? 0u : 1u, a, b, c});
        if (opc == DIV32) div_side_effects(a, b, c);
        else sdiv_side_effects(a, b, c);
        finish_alu(iw, a, has_imm, imm, false, true);
        break;
      }
      case LT32:
      case LTE32:
      case SLT32:
      case SLE32: {
        if (!read_b_c(iw, true, opc, &b, &c, &has_imm, &imm, &left_imm))
          return false;
        bool r;
        uint32_t kind;
        switch (opc) {
          case LT32: r = b < c; kind = 0; break;
          case LTE32: r = b <= c; kind = 1; break;
          case SLT32: r = (int32_t)b < (int32_t)c; kind = 2; break;
          default: r = (int32_t)b <= (int32_t)c; kind = 3; break;
        }
        uint32_t a = r ? 1 : 0;
        lt_ops.push_back({kind, a, b, c});
        finish_alu(iw, a, has_imm, imm, left_imm, false);
        break;
      }
      case NE32:
      case EQ32: {
        if (!read_b_c(iw, false, opc, &b, &c, &has_imm, &imm, &left_imm))
          return false;
        uint32_t a = opc == NE32 ? (b != c) : (b == c);
        com_ops.push_back({opc == NE32 ? 0u : 1u, a, b, c});
        finish_alu(iw, a, has_imm, imm, false, false);
        break;
      }
      case AND32:
      case OR32:
      case XOR32: {
        if (!read_b_c(iw, false, opc, &b, &c, &has_imm, &imm, &left_imm))
          return false;
        uint32_t a = opc == AND32 ? (b & c) : opc == OR32 ? (b | c) : (b ^ c);
        bitwise_ops.push_back(
            {opc == AND32 ? 0u : opc == OR32 ? 1u : 2u, a, b, c});
        finish_alu(iw, a, has_imm, imm, false, false);
        break;
      }
      case SHL32:
      case SHR32:
      case SRA32: {
        if (!read_b_c(iw, false, opc, &b, &c, &has_imm, &imm, &left_imm))
          return false;
        uint32_t sh = c & 31;
        uint32_t a, kind;
        uint32_t d = 1u << sh;
        if (opc == SHL32) {
          a = b << sh;
          kind = 0;
          mul_ops.push_back({0, a, b, d});
        } else if (opc == SHR32) {
          a = b >> sh;
          kind = 1;
          div_ops.push_back({0, a, b, d});
          div_side_effects(a, b, d);
        } else {
          // sra(b, s) = ~(~b >> s) for negative b, b >> s otherwise:
          // both legs delegate to an unsigned div row
          a = (uint32_t)((int32_t)b >> sh);
          kind = 2;
          uint32_t na = a, nb = b;
          if (b >> 31) {
            na = ~a;
            nb = ~b;
          }
          div_ops.push_back({0, na, nb, d});
          div_side_effects(na, nb, d);
          range_check(na);
          shift_ops.push_back({kind, a, b, c});
          finish_alu(iw, a, has_imm, imm, false, false);
          break;
        }
        shift_ops.push_back({kind, a, b, c});
        finish_alu(iw, a, has_imm, imm, false, true);
        break;
      }
      case FADD:
      case FSUB:
      case FMUL: {
        if (!read_b_c(iw, false, opc, &b, &c, &has_imm, &imm, &left_imm))
          return false;
        uint64_t x = b % FIELD_P, y = c % FIELD_P;
        uint64_t a64;
        if (opc == FADD) a64 = (x + y) % FIELD_P;
        else if (opc == FSUB) a64 = (x + FIELD_P - y) % FIELD_P;
        else a64 = (x * y) % FIELD_P;
        uint32_t a = (uint32_t)a64;
        nf_ops.push_back({opc == FADD ? 0u : opc == FSUB ? 1u : 2u, a, b, c});
        finish_alu(iw, a, has_imm, imm, false, true);
        break;
      }
      case WRITE: {
        if (!mem_read(fp + (uint32_t)iw.ops[1], &v, opc, 0)) return false;
        output_clk.push_back(clock);
        output_val.push_back(v);
        pc += 1;
        push_op(K_BUS_WITH_MEMORY, false, 0, iw);
        if (iw.ops[4] != 1 || iw.ops[2] != 0)
          return fail("WRITE: invalid operands");
        break;
      }
      default:
        return fail("Unrecognized opcode: " + std::to_string(opc));
    }
    return true;
  }

  bool run(uint64_t max_steps) {
    while (!stopped) {
      uint32_t cur_pc = pc;
      if (cur_pc >= rom.size()) return fail("pc out of bounds");
      if (!step()) return false;
      program_counts[cur_pc] += 1;
      if (clock > max_steps) return fail("step limit exceeded");
    }
    // STOP padding of program counts to next power of two
    uint64_t n2 = 1;
    while (n2 < clock) n2 <<= 1;
    for (uint64_t i = clock; i < n2; i++) program_counts[pc] += 1;
    return true;
  }
};

}  // namespace

extern "C" {

Vm* vm_create(const uint8_t* code, size_t code_len, uint32_t pc0,
              uint32_t fp0) {
  Vm* vm = new Vm();
  size_t n = code_len / 24;
  vm->rom.resize(n);
  for (size_t i = 0; i < n; i++) {
    std::memcpy(&vm->rom[i].opcode, code + i * 24, 4);
    std::memcpy(vm->rom[i].ops, code + i * 24 + 4, 20);
  }
  vm->program_counts.assign(n, 0);
  vm->pc = pc0;
  vm->fp = fp0;
  return vm;
}

void vm_set_static(Vm* vm, const uint32_t* addrs, const uint32_t* vals,
                   size_t n) {
  for (size_t i = 0; i < n; i++) vm->cells[addrs[i]] = vals[i];
}

void vm_set_advice(Vm* vm, const uint8_t* advice, size_t len) {
  vm->advice = advice;
  vm->advice_len = len;
}

int vm_run(Vm* vm, uint64_t max_steps) { return vm->run(max_steps) ? 0 : 1; }

const char* vm_error(Vm* vm) { return vm->error.c_str(); }

uint64_t vm_clock(Vm* vm) { return vm->clock; }
uint32_t vm_pc(Vm* vm) { return vm->pc; }
uint32_t vm_fp(Vm* vm) { return vm->fp; }

// bulk accessors: sizes then memcpy-out
size_t vm_num_cpu_ops(Vm* vm) { return vm->cpu_ops.size(); }
void vm_copy_cpu_ops(Vm* vm, uint8_t* kind, uint8_t* has_imm, uint32_t* imm,
                     uint32_t* opcode, int32_t* operands, uint32_t* pc,
                     uint32_t* fp) {
  size_t n = vm->cpu_ops.size();
  for (size_t i = 0; i < n; i++) {
    const CpuOp& op = vm->cpu_ops[i];
    kind[i] = op.kind;
    has_imm[i] = op.has_imm;
    imm[i] = op.imm;
    opcode[i] = op.opcode;
    std::memcpy(operands + 5 * i, op.operands, 20);
    pc[i] = op.pc;
    fp[i] = op.fp;
  }
}

size_t vm_num_mem_ops(Vm* vm) { return vm->mem_ops.size(); }
void vm_copy_mem_ops(Vm* vm, uint32_t* clk, uint8_t* is_write, uint32_t* addr,
                     uint32_t* value) {
  size_t n = vm->mem_ops.size();
  for (size_t i = 0; i < n; i++) {
    clk[i] = vm->mem_ops[i].clk;
    is_write[i] = vm->mem_ops[i].is_write;
    addr[i] = vm->mem_ops[i].addr;
    value[i] = vm->mem_ops[i].value;
  }
}

static void copy_alu(const std::vector<AluOp>& v, uint32_t* kind, uint32_t* a,
                     uint32_t* b, uint32_t* c) {
  for (size_t i = 0; i < v.size(); i++) {
    kind[i] = v[i].kind;
    a[i] = v[i].a;
    b[i] = v[i].b;
    c[i] = v[i].c;
  }
}

#define ALU_ACCESSORS(name, field)                                       \
  size_t vm_num_##name(Vm* vm) { return vm->field.size(); }              \
  void vm_copy_##name(Vm* vm, uint32_t* kind, uint32_t* a, uint32_t* b,  \
                      uint32_t* c) {                                     \
    copy_alu(vm->field, kind, a, b, c);                                  \
  }

ALU_ACCESSORS(add_ops, add_ops)
ALU_ACCESSORS(sub_ops, sub_ops)
ALU_ACCESSORS(mul_ops, mul_ops)
ALU_ACCESSORS(div_ops, div_ops)
ALU_ACCESSORS(lt_ops, lt_ops)
ALU_ACCESSORS(com_ops, com_ops)
ALU_ACCESSORS(bitwise_ops, bitwise_ops)
ALU_ACCESSORS(shift_ops, shift_ops)
ALU_ACCESSORS(nf_ops, nf_ops)

void vm_copy_range_counts(Vm* vm, uint32_t* out) {
  std::memcpy(out, vm->range_count.data(), 256 * 4);
}

size_t vm_num_program_counts(Vm* vm) { return vm->program_counts.size(); }
void vm_copy_program_counts(Vm* vm, uint32_t* out) {
  std::memcpy(out, vm->program_counts.data(),
              vm->program_counts.size() * 4);
}

size_t vm_num_outputs(Vm* vm) { return vm->output_clk.size(); }
void vm_copy_outputs(Vm* vm, uint64_t* clk, uint32_t* val) {
  std::memcpy(clk, vm->output_clk.data(), vm->output_clk.size() * 8);
  std::memcpy(val, vm->output_val.data(), vm->output_val.size() * 4);
}

size_t vm_num_cells(Vm* vm) { return vm->cells.size(); }
void vm_copy_cells(Vm* vm, uint32_t* addrs, uint32_t* vals) {
  size_t i = 0;
  for (const auto& kv : vm->cells) {
    addrs[i] = kv.first;
    vals[i] = kv.second;
    i++;
  }
}

void vm_free(Vm* vm) { delete vm; }

}  // extern "C"
