"""Program ROM: instruction words, operands, loader, disassembler.

Counterpart of valida_tpu/core/program.py; mirrors the Rust
`machine/src/program.rs`: 24 bytes per instruction (u32 opcode +
five little-endian i32 operands); operand e doubles as the immediate flag;
i32 operands map to field elements via sign (negative -> p - |x|).
"""

from __future__ import annotations

import dataclasses
import struct

from ..field import babybear as bb

OPERAND_ELEMENTS = 5
INSTRUCTION_ELEMENTS = 6
BYTES_PER_INSTR = 24


@dataclasses.dataclass
class Operands:
    """Five i32 operands (host ints, may be negative)."""

    ops: tuple

    def a(self):
        return self.ops[0]

    def b(self):
        return self.ops[1]

    def c(self):
        return self.ops[2]

    def d(self):
        return self.ops[3]

    def e(self):
        return self.ops[4]

    def is_imm(self):
        return self.ops[4]

    def to_field(self):
        """i32 -> canonical field elements (`Operands::from_i32_slice`)."""
        return tuple(x % bb.P for x in self.ops)


@dataclasses.dataclass
class InstructionWord:
    opcode: int
    operands: Operands

    def flatten(self):
        """[opcode, a..e] as canonical field elements."""
        return (self.opcode % bb.P,) + self.operands.to_field()


ZERO_INSTRUCTION = InstructionWord(0, Operands((0, 0, 0, 0, 0)))


class ProgramROM:
    def __init__(self, instructions=None):
        self.instructions: list[InstructionWord] = instructions or []

    def __len__(self):
        return len(self.instructions)

    def get_instruction(self, pc: int) -> InstructionWord:
        return self.instructions[pc]

    @staticmethod
    def from_machine_code(mc: bytes) -> "ProgramROM":
        out = []
        for off in range(0, len(mc) - len(mc) % BYTES_PER_INSTR, BYTES_PER_INSTR):
            opcode = struct.unpack_from("<I", mc, off)[0]
            ops = struct.unpack_from("<5i", mc, off + 4)
            out.append(InstructionWord(opcode, Operands(tuple(ops))))
        return ProgramROM(out)

    @staticmethod
    def from_file(path: str) -> "ProgramROM":
        with open(path, "rb") as f:
            return ProgramROM.from_machine_code(f.read())

    def to_machine_code(self) -> bytes:
        out = bytearray()
        for iw in self.instructions:
            out += struct.pack("<I", iw.opcode)
            out += struct.pack("<5i", *iw.operands.ops)
        return bytes(out)


# ---------------------------------------------------------------------------
# Disassembly (mirrors `InstructionWord::to_string`, program.rs:27-127)
# ---------------------------------------------------------------------------

from . import opcodes as OC  # noqa: E402


def disassemble(iw: InstructionWord) -> str:
    name = OC.OPCODE_NAMES.get(iw.opcode, f"UNKNOWN_OP:{iw.opcode}")
    o = iw.operands.ops

    def fp(i):
        return f"{o[i]}(fp)"

    def second_operand():
        return f"{o[2]}" if o[4] != 0 else f"{o[2]}(fp)"

    if iw.opcode == OC.IMM32:
        imm = (o[1] << 24) | (o[2] << 16) | (o[3] << 8) | o[4]
        body = f"{o[0]}(fp), {imm}"
    elif iw.opcode == OC.JAL:
        body = f"{o[0]}(fp), PC: {o[1] // 24}, {o[2]}"
    elif iw.opcode == OC.JALV:
        body = f"{o[0]}(fp), {o[1]}(fp), {o[2]}(fp)"
    elif iw.opcode == OC.LOADFP:
        body = f"{o[0]}(fp), {o[1]}"
    elif iw.opcode in (OC.BEQ, OC.BNE):
        body = f"{o[0] // 24}, {fp(1)}, {second_operand()}"
    elif iw.opcode == OC.STOP:
        body = ""
    elif iw.opcode in (OC.LOAD32, OC.LOADU8, OC.LOADS8):
        body = f"{o[0]}(fp), {o[2]}(fp)"
    elif iw.opcode in (OC.STORE32, OC.STOREU8):
        body = f"{o[1]}(fp), {o[2]}(fp)"
    else:
        body = f"{o[0]}(fp), {fp(1)}, {second_operand()}"
    return f"{name} {body}".rstrip()
