"""Program ROM chip
(counterpart of valida_tpu/chips/program.py; mirrors the Rust
`program/src/{lib,columns,stark}.rs`).

Main trace: one multiplicity column.  Preprocessed: (pc, opcode, operands).
Deviation (intended design): the program-bus receive is ENABLED, matching
the CPU chip's (also enabled) send — possible here because preprocessed
traces are part of the openings.
"""

from __future__ import annotations

import numpy as np

from ..air.types import VPCol, Interaction
from ..core import opcodes as OC
from ..core.program import ProgramROM
from ..core.word import MASK32
from ..field import babybear as bb
from .chip import Chip

MULTIPLICITY = 0
NUM_PROGRAM_COLS = 1

# Opcodes whose immediate operand (e == 1 -> operand c; d == 1 -> operand b
# for the lt family) is reinterpreted as a u32 by execution and therefore
# rewritten to `reduce(imm word)` in the CPU trace (cpu/src/lib.rs:359-381).
# The ROM encoding must match, or the program bus cannot balance for
# negative immediates (u32 reinterpretation != field negation).
_IMM_C_OPCODES = {
    OC.ADD32, OC.SUB32, OC.MUL32, OC.MULHS32, OC.MULHU32, OC.DIV32,
    OC.SDIV32, OC.LT32, OC.LTE32, OC.SLT32, OC.SLE32, OC.NE32, OC.EQ32,
    OC.AND32, OC.OR32, OC.XOR32, OC.SHL32, OC.SHR32, OC.SRA32,
    OC.BEQ, OC.BNE, OC.ADD, OC.SUB, OC.MUL,
}
_IMM_B_OPCODES = {OC.LT32, OC.LTE32, OC.SLT32, OC.SLE32}


def encode_operands_for_bus(iw) -> tuple:
    """Field encoding of an instruction's operands as the CPU trace emits
    them on the program bus."""
    ops = list(iw.operands.to_field())
    raw = iw.operands.ops
    if iw.opcode in _IMM_C_OPCODES and raw[4] == 1:
        ops[2] = (raw[2] & MASK32) % bb.P
    if iw.opcode in _IMM_B_OPCODES and raw[3] == 1:
        ops[1] = (raw[1] & MASK32) % bb.P
    return tuple(ops)

P_PC = 0
P_OPCODE = 1
P_OPERANDS = [2, 3, 4, 5, 6]
NUM_PREPROCESSED_COLS = 7


class ProgramChip(Chip):
    name = "program"

    def __init__(self):
        self.program_rom = ProgramROM()
        self.counts: list[int] = []

    def set_program_rom(self, rom: ProgramROM):
        self.program_rom = rom
        self.counts = [0] * len(rom)


    def width(self):
        return NUM_PROGRAM_COLS


    def preprocessed_trace(self):
        n = len(self.program_rom)
        n2 = 1 << max((n - 1).bit_length(), 0) if n else 1
        rows = np.zeros((n2, NUM_PREPROCESSED_COLS), dtype=np.uint32)
        for i, iw in enumerate(self.program_rom.instructions):
            rows[i, P_PC] = i
            rows[i, P_OPCODE] = iw.opcode % bb.P
            ops = encode_operands_for_bus(iw)
            for k in range(5):
                rows[i, P_OPERANDS[k]] = ops[k]
        rows[n:, P_PC] = np.arange(n, n2)
        return rows

    def global_receives(self, machine):
        if machine.program_bus() is None:
            return []
        fields = [VPCol.single_prep(P_PC), VPCol.single_prep(P_OPCODE)]
        fields += [VPCol.single_prep(P_OPERANDS[i]) for i in range(5)]
        return [
            Interaction(fields=fields,
                        count=VPCol.single_main(MULTIPLICITY),
                        bus=machine.program_bus())
        ]

    def eval(self, b):
        pass
