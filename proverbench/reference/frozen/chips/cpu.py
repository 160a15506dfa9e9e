"""CPU chip: execution state, core-ISA instruction semantics, trace
generation, memory/general/program bus traffic, and the CPU AIR.

Mirrors `cpu/src/{lib,columns,stark}.rs`.  Column order matches the
reference's CpuCols struct exactly.  Deviations (intended-design fixes,
flagged inline): pc-increment constraints also cover load/store/byte ops,
and the program-bus send is enabled (the reference comments it out at
cpu/src/lib.rs:138-158 because preprocessed openings were missing).

Counterpart of valida_tpu/chips/cpu.py.  The memory-channel routing and
the op arrays are made on the host with numpy, as in the JAX package; the
trace is built from them by torch operations on the prover's device.
"""

from __future__ import annotations


from ..air.types import VPCol, Interaction
from ..core.program import InstructionWord, BYTES_PER_INSTR
from .chip import Chip, IndexAllocator

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


    # -- trace generation ---------------------------------------------------

    def width(self):
        return NUM_CPU_COLS


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


