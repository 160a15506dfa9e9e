"""Program ROM: instruction words, operands, loader, disassembler.

Counterpart of valida_tpu/core/program.py; mirrors the Rust
`machine/src/program.rs`: 24 bytes per instruction (u32 opcode +
five little-endian i32 operands); operand e doubles as the immediate flag;
i32 operands map to field elements via sign (negative -> p - |x|).
"""

from __future__ import annotations

import dataclasses

from ..field import babybear as bb

OPERAND_ELEMENTS = 5
INSTRUCTION_ELEMENTS = 6
BYTES_PER_INSTR = 24


@dataclasses.dataclass
class Operands:
    """Five i32 operands (host ints, may be negative)."""

    ops: tuple


    def to_field(self):
        """i32 -> canonical field elements (`Operands::from_i32_slice`)."""
        return tuple(x % bb.P for x in self.ops)


@dataclasses.dataclass
class InstructionWord:
    opcode: int
    operands: Operands


ZERO_INSTRUCTION = InstructionWord(0, Operands((0, 0, 0, 0, 0)))


class ProgramROM:
    def __init__(self, instructions=None):
        self.instructions: list[InstructionWord] = instructions or []

    def __len__(self):
        return len(self.instructions)


# ---------------------------------------------------------------------------
# Disassembly (mirrors `InstructionWord::to_string`, program.rs:27-127)
# ---------------------------------------------------------------------------



