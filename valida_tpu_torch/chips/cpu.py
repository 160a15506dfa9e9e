"""CPU chip: execution state, core-ISA instruction semantics, trace
generation, memory/general/program bus traffic, and the CPU AIR.

Mirrors `cpu/src/{lib,columns,stark}.rs`.  Column order matches the
reference's CpuCols struct exactly.  Deviations (intended-design fixes,
flagged inline): pc-increment constraints also cover load/store/byte ops,
and the program-bus send is enabled (the reference comments it out at
cpu/src/lib.rs:138-158 because preprocessed openings were missing).

Counterpart of valida_tpu/chips/cpu.py.  The memory-channel routing and
the op arrays are made on the host, the routing in one C++ pass
(native/memroute.cpp); the trace is built from them by torch operations
on the prover's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..air.types import VPCol, Interaction
from ..core import opcodes as OC
from ..core.program import InstructionWord, Operands, BYTES_PER_INSTR
from ..core.word import (
    u32_to_bytes, bytes_to_u32, index_of_byte, addr_of_word, is_mul_4,
    sign_extend_byte, update_byte, MASK32,
)
from ..field import babybear as bb
from .chip import (Chip, IndexAllocator, assemble_columns, be_byte,
                   canon_inv, grow, mod_p, next_pow2, wide)
from .memory import ranks_in_clk

_a = IndexAllocator()
CLK = _a.scalar()
PC = _a.scalar()
FP = _a.scalar()
OPCODE = _a.scalar()
OPERANDS = _a.array(5)
# opcode flags (order matches OpcodeFlagCols)
IS_BUS_OP = _a.scalar()
IS_BUS_OP_WITH_MEM = _a.scalar()
IS_IMM_OP = _a.scalar()
IS_LEFT_IMM_OP = _a.scalar()
IS_LOAD = _a.scalar()
IS_LOAD_U8 = _a.scalar()
IS_LOAD_S8 = _a.scalar()
IS_STORE = _a.scalar()
IS_STORE_U8 = _a.scalar()
IS_BEQ = _a.scalar()
IS_BNE = _a.scalar()
IS_JAL = _a.scalar()
IS_JALV = _a.scalar()
IS_IMM32 = _a.scalar()
IS_ADVICE = _a.scalar()
IS_STOP = _a.scalar()
IS_LOADFP = _a.scalar()
DIFF = _a.scalar()
DIFF_INV = _a.scalar()
NOT_EQUAL = _a.scalar()
# 3 memory channels: used, is_read, addr, value[4]
MC_USED = []
MC_IS_READ = []
MC_ADDR = []
MC_VALUE = []
for _ in range(3):
    MC_USED.append(_a.scalar())
    MC_IS_READ.append(_a.scalar())
    MC_ADDR.append(_a.scalar())
    MC_VALUE.append(_a.word())
CLK_OR_ZERO = _a.scalar()
NUM_CPU_COLS = _a.width

# op kind -> code of the op arrays (native/interpreter.cpp's CpuKind)
KIND_CODE = {
    "load": 0, "load_u8": 1, "load_s8": 2, "store": 3, "store_u8": 4,
    "jal": 5, "jalv": 6, "beq": 7, "bne": 8, "imm32": 9, "advice": 10,
    "stop": 11, "loadfp": 12, "bus": 13, "bus_left_imm": 14,
    "bus_with_memory": 15,
}


class CpuChip(Chip):
    name = "cpu"

    def __init__(self):
        self.clock = 0
        self.pc = 0
        self.fp = 0
        self.registers: list[tuple[int, int]] = []  # (pc, fp) snapshots
        self.operations: list[tuple] = []  # (kind, imm or None)
        self.instructions: list[InstructionWord] = []
        # the op log as arrays (run_native(build_lists=False)); the lists
        # above are then empty: see op_arrays
        self.ops_arrays = None

    # -- execution-side plumbing (cpu/src/lib.rs:883-923) -------------------

    def push_op(self, kind: str, imm, opcode: int, operands: Operands):
        self.operations.append((kind, imm))
        self.instructions.append(InstructionWord(opcode, operands))
        self.registers.append((self.pc, self.fp))
        self.clock += 1

    def push_bus_op(self, imm, opcode, operands):
        self.pc += 1
        self.push_op("bus", imm, opcode, operands)

    def push_left_imm_bus_op(self, imm, opcode, operands):
        self.pc += 1
        self.push_op("bus_left_imm", imm, opcode, operands)

    def push_bus_op_with_memory(self, imm, opcode, operands):
        self.pc += 1
        self.push_op("bus_with_memory", imm, opcode, operands)

    # -- trace generation ---------------------------------------------------

    def width(self):
        return NUM_CPU_COLS

    def op_arrays(self):
        """The op log as arrays: (kind u8[n] (KIND_CODE), has_imm u8[n],
        imm u32[n] (0 where there is none), opcode u32[n], operands
        i32[n, 5], pre_pc u32[n], pre_fp u32[n]), the registers before each
        op.  `ops_arrays` when the native core set it, else made from the
        lists."""
        if self.ops_arrays is not None:
            return self.ops_arrays
        n = len(self.operations)
        kinds = np.fromiter((KIND_CODE[k] for k, _ in self.operations),
                            dtype=np.uint8, count=n)
        has_imm = np.fromiter((im is not None for _, im in self.operations),
                              dtype=np.uint8, count=n)
        imm = np.fromiter(
            ((im if im is not None else 0) for _, im in self.operations),
            dtype=np.uint32, count=n)
        opcode = np.fromiter((iw.opcode for iw in self.instructions),
                             dtype=np.uint32, count=n)
        operands = np.fromiter(
            (x for iw in self.instructions for x in iw.operands.ops),
            dtype=np.int64, count=5 * n).reshape(n, 5)
        regs = np.fromiter((x for r in self.registers[:n] for x in r),
                           dtype=np.int64, count=2 * n).reshape(n, 2)
        regs = (regs & 0xFFFFFFFF).astype(np.uint32)
        return (kinds, has_imm, imm, opcode,
                (operands & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
                regs[:, 0].copy(), regs[:, 1].copy())

    def device_trace_inputs(self, machine):
        """Compact op-log inputs for build_trace.  The per-clk memory
        channel ROUTING (which op lands on which of the 3 CPU channels)
        is resolved on the host into small index arrays, so the build is
        gathers and scatters with static shapes."""
        kinds, has_imm, imm, opcode, operands, pre_pc, pre_fp = \
            self.op_arrays()
        n = len(kinds)
        n2 = next_pow2(n)
        kinds = kinds.astype(np.uint32)
        has_imm = has_imm.astype(np.uint32)
        operands_u = operands.view(np.uint32)
        left_imm = (kinds == 14) & (has_imm != 0)

        # -- memory channel routing (cpu/src/lib.rs:244-283) ---------------
        from ..native import mem_channels

        channels = mem_channels(*machine.mem().op_arrays(), left_imm)
        inputs = (kinds, has_imm, imm, opcode, operands_u, pre_pc, pre_fp)
        for ch in channels:
            inputs += ch
        return inputs, (n, n2)

    @staticmethod
    def _channels_plain(mclk, mwrite, maddr, mvalue, left_imm):
        """((clk, addr, value) of channel 0, 1, 2): the memory ops routed
        to the three channels, in op order.  The plain version of
        native/memroute.cpp's `mem_cpu_channels`, which the tests hold it
        to (as the JAX package routes)."""
        mwrite = mwrite.astype(bool)
        # rank of each read within its clk group (groups contiguous);
        # reads: rank 0 -> channel 0 (1 for left-imm ops), rank 1 -> 1;
        # rank-2 reads (the STOREU8 merge) belong to the byte chip's
        # memory-bus send, not a CPU channel
        rank = ranks_in_clk(mclk, ~mwrite)
        is_left = left_imm[mclk]
        ch = np.where(
            mwrite, 2,
            np.where((rank == 0) & ~is_left, 0, np.where(rank <= 1, 1, -1))
        )
        channels = ()
        for ch_id in range(3):
            sel = ch == ch_id
            channels += ((mclk[sel], maddr[sel], mvalue[sel]),)
        return channels

    def build_trace(self, inputs, meta):
        (kinds, has_imm, imm, opcode, operands_u, pre_pc, pre_fp,
         t0, a0, v0, t1, a1, v1_, t2, a2, v2_) = wide(inputs)
        n, n2 = meta
        dev = kinds.device
        if n == 0:
            return torch.zeros((n2, NUM_CPU_COLS), dtype=torch.int32,
                               device=dev)

        def signed_mod_p(x_u):
            # x_u holds a two's-complement i32: its value mod p
            return (x_u - ((x_u >> 31) << 32)) % bb.P

        def flag(mask):
            return mask.to(torch.int64)

        def scatter(idx, vals):
            out = torch.zeros(n2, dtype=torch.int64, device=dev)
            if isinstance(vals, int):  # no host scalar copied in
                return out.index_fill_(0, idx, vals)
            out[idx] = vals
            return out

        def repeat_last(col):
            # STOP padding rows repeat the last real row's value
            return torch.cat([col, col[n - 1:].expand(n2 - n)])

        cols = {}
        # CLK runs over the FULL height (padding rows continue the count)
        cols[CLK] = mod_p(torch.arange(n2, dtype=torch.int64, device=dev))
        cols[PC] = repeat_last(mod_p(pre_pc))
        cols[FP] = repeat_last(mod_p(pre_fp))
        cols[OPCODE] = grow(opcode, n2, pad=OC.STOP)
        for i in range(5):
            cols[OPERANDS[i]] = grow(signed_mod_p(operands_u[:, i]), n2)
        flag_kinds = {
            IS_LOAD: (0,), IS_LOAD_U8: (1,), IS_LOAD_S8: (2,), IS_STORE: (3,),
            IS_STORE_U8: (4,), IS_JAL: (5,), IS_JALV: (6,), IS_BEQ: (7,),
            IS_BNE: (8,), IS_IMM32: (9,), IS_ADVICE: (10,), IS_LOADFP: (12,),
            IS_BUS_OP: (13, 14, 15),
        }
        for col, ks in flag_kinds.items():
            mask = kinds == ks[0]
            for k in ks[1:]:
                mask = mask | (kinds == k)
            cols[col] = grow(flag(mask), n2)
        cols[IS_STOP] = grow(flag(kinds == 11), n2, pad=1)
        with_mem = kinds == 15
        cols[IS_BUS_OP_WITH_MEM] = grow(flag(with_mem), n2)
        cols[CLK_OR_ZERO] = grow(
            torch.where(with_mem, torch.arange(n, device=dev), 0), n2)
        left_imm = (kinds == 14) & (has_imm != 0)
        right_imm = (has_imm != 0) & ~left_imm
        cols[IS_LEFT_IMM_OP] = grow(flag(left_imm), n2)
        cols[IS_IMM_OP] = grow(flag(right_imm), n2)
        ones = torch.ones(n2, dtype=torch.int64, device=dev)
        cols[MC_IS_READ[0]] = ones
        cols[MC_IS_READ[1]] = ones

        for ch_id, (tgt, addr, val) in enumerate(
            ((t0, a0, v0), (t1, a1, v1_), (t2, a2, v2_))
        ):
            cols[MC_USED[ch_id]] = scatter(tgt, 1)
            cols[MC_ADDR[ch_id]] = scatter(tgt, mod_p(addr))
            for i2 in range(4):
                cols[MC_VALUE[ch_id][i2]] = scatter(tgt, be_byte(val, i2))

        # -- immediate overrides (cpu/src/lib.rs:359-381) ------------------
        for sel, ch_id, op_col in ((left_imm, 0, OPERANDS[1]),
                                   (right_imm, 1, OPERANDS[2])):
            selg = grow(flag(sel), n2) != 0
            for i2 in range(4):
                cols[MC_VALUE[ch_id][i2]] = torch.where(
                    selg, grow(be_byte(imm, i2), n2),
                    cols[MC_VALUE[ch_id][i2]])
            cols[op_col] = torch.where(selg, grow(mod_p(imm), n2),
                                       cols[op_col])

        # -- word-equality witness (cpu/src/lib.rs:285-315) ----------------
        diff = None
        for i in range(4):
            d = (cols[MC_VALUE[0][i]] - cols[MC_VALUE[1][i]]) % bb.P
            sq = d * d % bb.P
            diff = sq if diff is None else (diff + sq) % bb.P
        cols[DIFF] = diff
        cols[DIFF_INV] = canon_inv(diff)
        cols[NOT_EQUAL] = flag(diff != 0)
        return assemble_columns(NUM_CPU_COLS, n2, cols, dev)

    # -- interactions (cpu/src/lib.rs:99-159) -------------------------------

    def global_sends(self, machine):
        sends = []
        for ch in range(3):
            fields = [
                VPCol.single_main(MC_IS_READ[ch]),
                VPCol.single_main(CLK),
                VPCol.single_main(MC_ADDR[ch]),
                VPCol.const(0),  # is_static_initial
            ] + [VPCol.single_main(MC_VALUE[ch][i]) for i in range(4)]
            sends.append(
                Interaction(fields=fields,
                            count=VPCol.single_main(MC_USED[ch]),
                            bus=machine.mem_bus())
            )
        # general bus
        fields = [VPCol.single_main(OPCODE)]
        for ch in range(3):
            fields += [VPCol.single_main(MC_VALUE[ch][i]) for i in range(4)]
        fields.append(VPCol.single_main(CLK_OR_ZERO))
        sends.append(
            Interaction(fields=fields,
                        count=VPCol.single_main(IS_BUS_OP),
                        bus=machine.general_bus())
        )
        # program bus (intended design; disabled in the reference)
        if machine.program_bus() is not None:
            fields = [VPCol.single_main(PC), VPCol.single_main(OPCODE)]
            fields += [VPCol.single_main(OPERANDS[i]) for i in range(5)]
            sends.append(
                Interaction(fields=fields, count=VPCol.one(),
                            bus=machine.program_bus())
            )
        # byte bus: delegate byte extraction / sign extension / merge to
        # the byte chip (no reference counterpart — byte-op channels are
        # unconstrained there; chips/byte.py).  Message shape:
        # (opcode, clk, src byte ptr, src aligned addr, src word,
        #  dst byte ptr, dst aligned addr, written word)
        if getattr(machine, "byte_bus", None) is not None \
                and machine.byte_bus() is not None:
            base = [1 << 24, 1 << 16, 1 << 8, 1]
            ch0_word = VPCol(
                [(("main", MC_VALUE[0][i]), base[i]) for i in range(4)])
            common_mid = [VPCol.single_main(MC_ADDR[1])] + [
                VPCol.single_main(MC_VALUE[1][i]) for i in range(4)]
            common_tail = [VPCol.single_main(MC_ADDR[2])] + [
                VPCol.single_main(MC_VALUE[2][i]) for i in range(4)]
            # LOADU8/LOADS8: src ptr was read on ch0, dst ptr is fp + a
            fields = ([VPCol.single_main(OPCODE), VPCol.single_main(CLK),
                       ch0_word] + common_mid
                      + [VPCol.sum_main([FP, OPERANDS[0]])] + common_tail)
            sends.append(Interaction(
                fields=fields,
                count=VPCol.sum_main([IS_LOAD_U8, IS_LOAD_S8]),
                bus=machine.byte_bus()))
            # STOREU8: src ptr is fp + c, dst ptr was read on ch0
            fields = ([VPCol.single_main(OPCODE), VPCol.single_main(CLK),
                       VPCol.sum_main([FP, OPERANDS[2]])] + common_mid
                      + [ch0_word] + common_tail)
            sends.append(Interaction(
                fields=fields, count=VPCol.single_main(IS_STORE_U8),
                bus=machine.byte_bus()))
        return sends

    # -- AIR (cpu/src/stark.rs) ---------------------------------------------

    def eval(self, b):
        local = b.main_local
        nxt = b.main_next
        base = [1 << 24, 1 << 16, 1 << 8, 1]

        def reduce(word_idx, row):
            return (row[word_idx[0]] * base[0] + row[word_idx[1]] * base[1]
                    + row[word_idx[2]] * base[2] + row[word_idx[3]] * base[3])

        one = 1
        is_load = local[IS_LOAD]
        is_store = local[IS_STORE]
        is_jal = local[IS_JAL]
        is_jalv = local[IS_JALV]
        is_beq = local[IS_BEQ]
        is_bne = local[IS_BNE]
        is_imm32 = local[IS_IMM32]
        is_loadfp = local[IS_LOADFP]
        is_imm_op = local[IS_IMM_OP]
        is_left_imm_op = local[IS_LEFT_IMM_OP]
        is_bus_op = local[IS_BUS_OP]

        # pc constraints
        # Deviation: the reference omits load/store/byte-op and advice rows
        # from should_increment_pc for loads/stores (soundness gap); those
        # ops always advance pc in execution, so we constrain them too.
        should_increment_pc = (
            is_imm32 + is_loadfp + is_bus_op + local[IS_ADVICE]
            + is_load + is_store + local[IS_LOAD_U8] + local[IS_LOAD_S8]
            + local[IS_STORE_U8]
        )
        incremented_pc = local[PC] + 1
        b.when_transition().when(should_increment_pc).assert_eq(
            nxt[PC], incremented_pc
        )
        equal = one - local[NOT_EQUAL]
        target = local[OPERANDS[0]]
        beq_next = equal * target + BYTES_PER_INSTR * local[NOT_EQUAL] * incremented_pc
        bne_next = BYTES_PER_INSTR * equal * incremented_pc + local[NOT_EQUAL] * target
        b.when_transition().when(is_beq).assert_eq(
            BYTES_PER_INSTR * nxt[PC], beq_next
        )
        b.when_transition().when(is_bne).assert_eq(
            BYTES_PER_INSTR * nxt[PC], bne_next
        )
        b.when_transition().when(is_jal).assert_eq(
            BYTES_PER_INSTR * nxt[PC], local[OPERANDS[1]]
        )
        b.when_transition().when(is_jalv).assert_eq(
            BYTES_PER_INSTR * nxt[PC], reduce(MC_VALUE[0], local)
        )

        # fp constraints
        b.when_transition().when(is_jal).assert_eq(
            nxt[FP], local[FP] + local[OPERANDS[2]]
        )
        b.when_transition().when(is_jalv).assert_eq(
            nxt[FP], local[FP] + reduce(MC_VALUE[1], local)
        )
        b.when_transition().when(one - is_jal - is_jalv).assert_eq(
            nxt[FP], local[FP]
        )

        # word equality gadget
        diff_expr = None
        for i in range(4):
            d = local[MC_VALUE[0][i]] - local[MC_VALUE[1][i]]
            sq = d * d
            diff_expr = sq if diff_expr is None else diff_expr + sq
        b.assert_eq(local[DIFF], diff_expr)
        b.assert_bool(local[NOT_EQUAL])
        b.assert_eq(local[NOT_EQUAL], local[DIFF] * local[DIFF_INV])
        b.assert_zero((one - local[NOT_EQUAL]) * local[DIFF])

        # memory channels
        is_u8 = local[IS_LOAD_U8]
        is_s8 = local[IS_LOAD_S8]
        is_su8 = local[IS_STORE_U8]
        is_advice = local[IS_ADVICE]
        is_stop = local[IS_STOP]
        byte_any = is_u8 + is_s8 + is_su8
        for f in [is_load, is_store, is_jal, is_jalv, is_beq, is_bne,
                  is_imm32, is_loadfp, is_imm_op, is_left_imm_op, is_bus_op,
                  is_u8, is_s8, is_su8, is_advice, is_stop]:
            b.assert_bool(f)

        # Intended-design fix: bus-ops-with-memory (WRITE) perform a single
        # read and no memory write, so the channel-usage rules below use
        # is_pure_bus for the "ALU-shaped" bus ops and carve out with-mem
        # rows explicitly (the reference's rules contradict its own WRITE).
        is_with_mem = local[IS_BUS_OP_WITH_MEM]
        b.assert_bool(is_with_mem)
        b.assert_zero(is_with_mem * (one - is_bus_op))
        is_pure_bus = is_bus_op - is_with_mem

        addr_a = local[FP] + local[OPERANDS[0]]
        addr_b = local[FP] + local[OPERANDS[1]]
        addr_c = local[FP] + local[OPERANDS[2]]

        b.assert_one(local[MC_IS_READ[0]])
        b.assert_one(local[MC_IS_READ[1]])
        b.assert_zero(local[MC_IS_READ[2]])

        read1 = local[MC_ADDR[0]]
        read2 = local[MC_ADDR[1]]
        write = local[MC_ADDR[2]]

        b.when(is_jalv + is_beq + is_bne + is_bus_op * (one - is_left_imm_op)).assert_eq(
            read1, addr_b
        )
        b.when(is_load + is_store).assert_eq(read1, addr_c)
        # byte ops (deviation: unconstrained in the reference): the loads
        # read the src byte pointer from fp+c, STOREU8 reads the dst byte
        # pointer from fp+b
        b.when(is_u8 + is_s8).assert_eq(read1, addr_c)
        b.when(is_su8).assert_eq(read1, addr_b)
        b.when(
            is_load + is_store + is_jalv + is_beq + is_bne
            + (one - is_left_imm_op) * is_bus_op + byte_any
        ).assert_one(local[MC_USED[0]])
        b.when(is_jal + is_left_imm_op + is_loadfp + is_imm32 + is_advice
               + is_stop).assert_zero(local[MC_USED[0]])

        b.when(is_load).assert_eq(read2, reduce(MC_VALUE[0], local))
        b.when(is_store).assert_eq(read2, addr_b)
        b.when(is_jalv + (one - is_imm_op) * is_pure_bus).assert_eq(read2, addr_c)
        # byte ops use ch1 for the aligned source word; its address is
        # constrained by the byte chip (MC_ADDR[1] is a byte-bus field)
        b.when(
            is_load + is_store + is_jalv
            + (one - is_imm_op) * (is_beq + is_bne + is_pure_bus) + byte_any
        ).assert_one(local[MC_USED[1]])
        b.when(
            is_jal + is_imm_op * (is_beq + is_bne + is_pure_bus) + is_loadfp
            + is_imm32 + is_with_mem + is_advice + is_stop
        ).assert_zero(local[MC_USED[1]])

        b.when(is_load + is_jal + is_jalv + is_imm32 + is_pure_bus + is_loadfp
               + is_advice).assert_eq(write, addr_a)
        b.when(is_store).assert_eq(write, reduce(MC_VALUE[1], local))
        # byte-op write addresses (aligned) are constrained by the byte
        # chip (MC_ADDR[2] is a byte-bus field)

        def word_eq_sq(wa, wb_idx):
            acc = None
            for i in range(4):
                d = local[wa[i]] - local[wb_idx[i]]
                sq = d * d
                acc = sq if acc is None else acc + sq
            return acc

        b.when(is_store).assert_zero(word_eq_sq(MC_VALUE[0], MC_VALUE[2]))
        b.when(is_load).assert_zero(word_eq_sq(MC_VALUE[1], MC_VALUE[2]))
        b.when_transition().when(is_jal + is_jalv).assert_eq(
            BYTES_PER_INSTR * (local[PC] + 1), reduce(MC_VALUE[2], local)
        )
        imm32_word = [OPERANDS[1], OPERANDS[2], OPERANDS[3], OPERANDS[4]]
        acc = None
        for i in range(4):
            d = local[MC_VALUE[2][i]] - local[imm32_word[i]]
            sq = d * d
            acc = sq if acc is None else acc + sq
        b.when(is_imm32).assert_zero(acc)
        b.when(is_loadfp).assert_eq(addr_b, reduce(MC_VALUE[2], local))
        b.when(
            is_store + is_load + is_jal + is_jalv + is_imm32 + is_loadfp
            + is_pure_bus + byte_any + is_advice
        ).assert_one(local[MC_USED[2]])
        b.when(is_beq + is_bne + is_with_mem + is_stop).assert_zero(
            local[MC_USED[2]]
        )

        # clock constraints
        b.when_first_row().assert_zero(local[CLK])
        b.when_transition().assert_eq(local[CLK] + 1, nxt[CLK])
        b.when(local[IS_BUS_OP_WITH_MEM]).assert_eq(local[CLK], local[CLK_OR_ZERO])
        b.when(one - local[IS_BUS_OP_WITH_MEM]).assert_zero(local[CLK_OR_ZERO])

        # immediate constraints
        b.assert_bool(is_imm_op + is_left_imm_op)
        b.when(is_imm_op).assert_eq(
            local[OPERANDS[2]], reduce(MC_VALUE[1], local)
        )
        b.when(is_left_imm_op).assert_eq(
            local[OPERANDS[1]], reduce(MC_VALUE[0], local)
        )

        # stop constraints
        b.when_transition().when(local[IS_STOP]).assert_eq(nxt[PC], local[PC])
        b.when_last_row().assert_one(local[IS_STOP])


# ---------------------------------------------------------------------------
# Core-ISA instruction semantics (cpu/src/lib.rs:398-881)
# ---------------------------------------------------------------------------


def _rd(machine, addr, ordinal, opcode):
    return machine.mem().read(machine.cpu().clock, addr & MASK32, True,
                              machine.cpu().pc, opcode, ordinal)


def ex_load32(m, ops):
    cpu = m.cpu()
    clk = cpu.clock
    ra1 = (cpu.fp + ops.c()) & MASK32
    assert is_mul_4(ra1), "LOAD32: read address location not a multiple of 4"
    ra2 = _rd(m, ra1, 0, OC.LOAD32)
    assert is_mul_4(ra2), "LOAD32: read address not a multiple of 4"
    wa = (cpu.fp + ops.a()) & MASK32
    assert is_mul_4(wa), "LOAD32: write address location not a multiple of 4"
    cell = _rd(m, ra2, 1, OC.LOAD32)
    m.mem().write(clk, wa, cell, True)
    cpu.pc += 1
    cpu.push_op("load", None, OC.LOAD32, ops)


def _ex_load_byte(m, ops, opcode, kind, extend):
    from .byte import register_range_checks

    cpu = m.cpu()
    clk = cpu.clock
    ra_loc = (cpu.fp + ops.c()) & MASK32
    ra = _rd(m, ra_loc, 0, opcode)
    cell = _rd(m, addr_of_word(ra), 1, opcode)
    byte = u32_to_bytes(cell)[index_of_byte(ra)]
    wa = addr_of_word((cpu.fp + ops.a()) & MASK32)
    m.mem().write(clk, wa, extend(byte), True)
    register_range_checks(m, addr_of_word(ra), wa, byte)
    cpu.pc += 1
    cpu.push_op(kind, None, opcode, ops)


def ex_loadu8(m, ops):
    _ex_load_byte(m, ops, OC.LOADU8, "load_u8", lambda b: b)


def ex_loads8(m, ops):
    _ex_load_byte(m, ops, OC.LOADS8, "load_s8", sign_extend_byte)


def ex_store32(m, ops):
    # Channel order follows the AIR (cpu/src/stark.rs:121-122,144-145):
    # channel 0 reads the VALUE at fp+c, channel 1 reads the cell holding
    # the target address at fp+b.  The reference's execute reads them in
    # the opposite order (cpu/src/lib.rs:629-639), contradicting its own
    # (never-exercised) store constraints — see docs/deviations.md.
    cpu = m.cpu()
    clk = cpu.clock
    ra = (cpu.fp + ops.c()) & MASK32
    assert is_mul_4(ra), "STORE32: read address not a multiple of 4"
    wa_loc = (cpu.fp + ops.b()) & MASK32
    assert is_mul_4(wa_loc), "STORE32: write address location not a multiple of 4"
    cell = _rd(m, ra, 0, OC.STORE32)
    wa = _rd(m, wa_loc, 1, OC.STORE32)
    assert is_mul_4(wa), "STORE32: write address not a multiple of 4"
    m.mem().write(clk, wa, cell, True)
    cpu.pc += 1
    cpu.push_op("store", None, OC.STORE32, ops)


def ex_storeu8(m, ops):
    from .byte import register_range_checks

    cpu = m.cpu()
    clk = cpu.clock
    ra = (cpu.fp + ops.c()) & MASK32
    wa_loc = (cpu.fp + ops.b()) & MASK32
    wa = _rd(m, wa_loc, 0, OC.STOREU8)
    cell = _rd(m, addr_of_word(ra), 1, OC.STOREU8)
    byte = u32_to_bytes(cell)[index_of_byte(ra)]
    wa_idx = addr_of_word(wa)
    # the read-modify-write merge read is LOGGED (read_or_init, mirroring
    # cpu/src/lib.rs:687) and proved via the byte chip's memory-bus send
    cur = m.mem().read_or_init(clk, wa_idx, True)
    m.mem().write(clk, wa_idx, update_byte(cur, byte, index_of_byte(wa)), True)
    register_range_checks(m, addr_of_word(ra), wa_idx, byte)
    cpu.pc += 1
    cpu.push_op("store_u8", None, OC.STOREU8, ops)


def ex_jal(m, ops):
    cpu = m.cpu()
    clk = cpu.clock
    wa = (cpu.fp + ops.a()) & MASK32
    m.mem().write(clk, wa, (BYTES_PER_INSTR * (cpu.pc + 1)) & MASK32, True)
    cpu.pc = (ops.b() & MASK32) // BYTES_PER_INSTR
    cpu.fp = (cpu.fp + ops.c()) & MASK32
    cpu.push_op("jal", None, OC.JAL, ops)


def ex_jalv(m, ops):
    cpu = m.cpu()
    clk = cpu.clock
    wa = (cpu.fp + ops.a()) & MASK32
    m.mem().write(clk, wa, (BYTES_PER_INSTR * (cpu.pc + 1)) & MASK32, True)
    target = _rd(m, (cpu.fp + ops.b()) & MASK32, 0, OC.JALV)
    cpu.pc = target // BYTES_PER_INSTR
    offset = _rd(m, (cpu.fp + ops.c()) & MASK32, 2, OC.JALV)
    cpu.fp = (cpu.fp + offset) & MASK32
    cpu.push_op("jalv", None, OC.JALV, ops)


def _branch(m, ops, opcode, taken_if_equal):
    cpu = m.cpu()
    imm = None
    cell1 = _rd(m, (cpu.fp + ops.b()) & MASK32, 0, opcode)
    if ops.is_imm() == 1:
        imm = ops.c() & MASK32
        cell2 = imm
    else:
        cell2 = _rd(m, (cpu.fp + ops.c()) & MASK32, 1, opcode)
    if (cell1 == cell2) == taken_if_equal:
        cpu.pc = (ops.a() & MASK32) // BYTES_PER_INSTR
    else:
        cpu.pc += 1
    cpu.push_op("beq" if taken_if_equal else "bne", imm, opcode, ops)


def ex_beq(m, ops):
    _branch(m, ops, OC.BEQ, True)


def ex_bne(m, ops):
    _branch(m, ops, OC.BNE, False)


def ex_imm32(m, ops):
    cpu = m.cpu()
    clk = cpu.clock
    wa = (cpu.fp + ops.a()) & MASK32
    value = bytes_to_u32([x & 0xFF for x in
                          (ops.b(), ops.c(), ops.d(), ops.e())])
    m.mem().write(clk, wa, value, True)
    cpu.pc += 1
    cpu.push_op("imm32", None, OC.IMM32, ops)


def ex_stop(m, ops):
    cpu = m.cpu()
    cpu.push_op("stop", None, OC.STOP, ops)


def ex_loadfp(m, ops):
    cpu = m.cpu()
    clk = cpu.clock
    wa = (cpu.fp + ops.a()) & MASK32
    m.mem().write(clk, wa, (cpu.fp + ops.b()) & MASK32, True)
    cpu.pc += 1
    cpu.push_op("loadfp", None, OC.LOADFP, ops)


def ex_read_advice(m, ops, advice):
    cpu = m.cpu()
    clk = cpu.clock
    addr = (cpu.fp + ops.a()) & MASK32
    byte = advice.get_advice()
    value = byte if byte is not None else MASK32
    m.mem().write(clk, addr, value, True)
    cpu.pc += 1
    cpu.push_op("advice", None, OC.READ_ADVICE, ops)
