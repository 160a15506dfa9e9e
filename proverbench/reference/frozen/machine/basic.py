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
from ..chips.cpu import CpuChip
from ..chips.memory import MemoryChip
from ..chips.program import ProgramChip
from ..chips.static_data import StaticDataChip
from ..chips.byte import ByteChip
from ..chips.range import RangeCheckerChip
from ..chips.output import OutputChip
from ..chips import alu
from .machine import Machine

DID_STOP = "did_stop"
DID_NOT_STOP = "did_not_stop"


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


