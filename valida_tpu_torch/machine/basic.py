"""BasicMachine: the canonical Valida machine (the Rust reference's 14
chips and the byte chip).

Counterpart of valida_tpu/machine/basic.py.  The interpreter runs on the
host, as the Python step loop (`run`) or the C++ core (`run_native`); the
prover builds the op-log chips' traces on its device.

Mirrors `basic/src/lib.rs:66-124`: chip order [cpu, program, mem, add, sub,
mul, div, shift, lt, com, bitwise, output, range, static_data]; bus
assignment general=G0, program=G1, mem=G2, range=G3
(basic/src/lib.rs:1191-1211); run = step loop + STOP padding of program
counts (basic/src/lib.rs:126-145).
"""

from __future__ import annotations

from ..air.types import Bus, GLOBAL
from ..core import opcodes as OC
from ..core.advice import AdviceProvider, FixedAdviceProvider
from ..core.program import ProgramROM
from ..chips.cpu import (
    CpuChip, ex_load32, ex_loadu8, ex_loads8, ex_store32, ex_storeu8,
    ex_jal, ex_jalv, ex_beq, ex_bne, ex_imm32, ex_stop, ex_loadfp,
    ex_read_advice,
)
from ..chips.memory import MemoryChip
from ..chips.program import ProgramChip
from ..chips.static_data import StaticDataChip
from ..chips.byte import ByteChip
from ..chips.range import RangeCheckerChip
from ..chips.output import OutputChip, ex_write
from ..chips import alu
from ..utils import span
from .machine import Machine

DID_STOP = "did_stop"
DID_NOT_STOP = "did_not_stop"

_DISPATCH = {
    OC.LOAD32: ex_load32,
    OC.LOADU8: ex_loadu8,
    OC.LOADS8: ex_loads8,
    OC.STORE32: ex_store32,
    OC.STOREU8: ex_storeu8,
    OC.JAL: ex_jal,
    OC.JALV: ex_jalv,
    OC.BEQ: ex_beq,
    OC.BNE: ex_bne,
    OC.IMM32: ex_imm32,
    OC.STOP: ex_stop,
    OC.LOADFP: ex_loadfp,
    OC.ADD32: alu.ex_add32,
    OC.SUB32: alu.ex_sub32,
    OC.MUL32: alu.ex_mul32,
    OC.MULHS32: alu.ex_mulhs32,
    OC.MULHU32: alu.ex_mulhu32,
    OC.DIV32: alu.ex_div32,
    OC.SDIV32: alu.ex_sdiv32,
    OC.LT32: alu.ex_lt32,
    OC.LTE32: alu.ex_lte32,
    OC.SLT32: alu.ex_slt32,
    OC.SLE32: alu.ex_sle32,
    OC.NE32: alu.ex_ne32,
    OC.EQ32: alu.ex_eq32,
    OC.AND32: alu.ex_and32,
    OC.OR32: alu.ex_or32,
    OC.XOR32: alu.ex_xor32,
    OC.SHL32: alu.ex_shl32,
    OC.SHR32: alu.ex_shr32,
    OC.SRA32: alu.ex_sra32,
    OC.WRITE: ex_write,
}


class BasicMachine(Machine):
    def __init__(self):
        self._cpu = CpuChip()
        self._program = ProgramChip()
        self._mem = MemoryChip()
        self._add_u32 = alu.Add32Chip()
        self._sub_u32 = alu.Sub32Chip()
        self._mul_u32 = alu.Mul32Chip()
        self._div_u32 = alu.Div32Chip()
        self._shift_u32 = alu.Shift32Chip()
        self._lt_u32 = alu.Lt32Chip()
        self._com_u32 = alu.Com32Chip()
        self._bitwise_u32 = alu.Bitwise32Chip()
        self._output = OutputChip()
        self._range = RangeCheckerChip(256)
        self._static_data = StaticDataChip()
        self._byte = ByteChip()

    # chip accessors (basic/src/lib.rs:1213-1351)
    def cpu(self):
        return self._cpu

    def program(self):
        return self._program

    def mem(self):
        return self._mem

    def add_u32(self):
        return self._add_u32

    def sub_u32(self):
        return self._sub_u32

    def mul_u32(self):
        return self._mul_u32

    def div_u32(self):
        return self._div_u32

    def shift_u32(self):
        return self._shift_u32

    def lt_u32(self):
        return self._lt_u32

    def com_u32(self):
        return self._com_u32

    def bitwise_u32(self):
        return self._bitwise_u32

    def output(self):
        return self._output

    def range(self):
        return self._range

    def static_data(self):
        return self._static_data

    def byte(self):
        return self._byte

    def chips(self):
        # the reference's 14 chips + the byte chip (deviation: byte-op
        # delegation so LOADU8/LOADS8/STOREU8 are actually constrained,
        # chips/byte.py)
        return [
            self._cpu, self._program, self._mem, self._add_u32, self._sub_u32,
            self._mul_u32, self._div_u32, self._shift_u32, self._lt_u32,
            self._com_u32, self._bitwise_u32, self._output, self._range,
            self._static_data, self._byte,
        ]

    # bus assignment (basic/src/lib.rs:1191-1211)
    def general_bus(self):
        return Bus(GLOBAL, 0)

    def program_bus(self):
        return Bus(GLOBAL, 1)

    def mem_bus(self):
        return Bus(GLOBAL, 2)

    def range_bus(self):
        return Bus(GLOBAL, 3)

    def byte_bus(self):
        return Bus(GLOBAL, 4)

    # -- execution ----------------------------------------------------------

    def initialize_memory(self):
        for addr, value in self._static_data.cells.items():
            self._mem.write_static(addr, value)

    # subclass compositions override to extend/restrict the ISA
    # (machine/compositions.py)
    DISPATCH = _DISPATCH

    def step(self, advice: AdviceProvider):
        pc = self._cpu.pc
        iw = self._program.program_rom.get_instruction(pc)
        if iw.opcode == OC.READ_ADVICE:
            ex_read_advice(self, iw.operands, advice)
        else:
            fn = type(self).DISPATCH.get(iw.opcode)
            if fn is None:
                raise RuntimeError(f"Unrecognized opcode: {iw.opcode}")
            fn(self, iw.operands)
        self._program.read_word(pc)
        return DID_STOP if iw.opcode == OC.STOP else DID_NOT_STOP

    def run_native(self, advice_bytes: bytes = b"",
                   build_lists: bool = True):
        """Execute the loaded program with the C++ interpreter core
        (native/), leaving the chips in the state `run` leaves them in.

        build_lists=False hands the op logs to the chips as numpy arrays
        (the trace builders read them; the Python logs stay empty).  Raises
        `native.NativeRunError` if the core cannot be built or loaded: it
        never falls back to `run`."""
        from ..native import run_native

        run_native(self, build_lists=build_lists, advice=advice_bytes)
        # memory/output sort-delta limbs feed the range bus
        with span("execute: range checks"):
            self._mem.register_range_checks(self)
            self._output.register_range_checks(self)

    def run(self, program: ProgramROM | None = None,
            advice: AdviceProvider | None = None):
        if program is not None and len(self._program.program_rom) == 0:
            self._program.set_program_rom(program)
        advice = advice or FixedAdviceProvider.empty()
        self.initialize_memory()
        while True:
            if self.step(advice) == DID_STOP:
                break
        # pad program counts with STOP reads to the next power of two
        clock = self._cpu.clock
        n2 = 1 << max((clock - 1).bit_length(), 0) if clock else 1
        for _ in range(n2 - clock):
            self._program.read_word(self._cpu.pc)
        # memory/output sort-delta limbs feed the range bus
        self._mem.register_range_checks(self)
        self._output.register_range_checks(self)
