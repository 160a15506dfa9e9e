"""Two-pass assembler (port of `assembler/src/lib.rs` +
`assembler/grammar/assembly.pest` semantics).

Labels resolve to byte offsets (24 per instruction); immediate-variant
mnemonics (suffix `i`) set operand e = 1; left-immediate comparison forms
(prefix `i`) set operand d = 1; operand counts are normalized per opcode
class exactly as the reference does.

Counterpart of valida_tpu/tooling/assembler.py.
"""

from __future__ import annotations

import re
import struct

from ..core import opcodes as OC
from ..core.program import BYTES_PER_INSTR

_MNEMONIC_OPCODES = {
    "lw": OC.LOAD32, "loadu8": OC.LOADU8, "loads8": OC.LOADS8,
    "sw": OC.STORE32, "storeu8": OC.STOREU8,
    "jal": OC.JAL, "jalv": OC.JALV,
    "beq": OC.BEQ, "beqi": OC.BEQ, "bne": OC.BNE, "bnei": OC.BNE,
    "imm32": OC.IMM32, "stop": OC.STOP, "advread": OC.READ_ADVICE,
    "add": OC.ADD32, "addi": OC.ADD32, "sub": OC.SUB32, "subi": OC.SUB32,
    "mul": OC.MUL32, "muli": OC.MUL32,
    "mulhs": OC.MULHS32, "mulhsi": OC.MULHS32,
    "mulhu": OC.MULHU32, "mulhui": OC.MULHU32,
    "div": OC.DIV32, "divi": OC.DIV32, "sdiv": OC.SDIV32, "sdivi": OC.SDIV32,
    "ilt": OC.LT32, "lt": OC.LT32, "lti": OC.LT32,
    "ilte": OC.LTE32, "lte": OC.LTE32, "ltei": OC.LTE32,
    "islt": OC.SLT32, "slt": OC.SLT32, "slti": OC.SLT32,
    "isle": OC.SLE32, "sle": OC.SLE32, "slei": OC.SLE32,
    "shl": OC.SHL32, "shli": OC.SHL32, "shr": OC.SHR32, "shri": OC.SHR32,
    "sra": OC.SRA32, "srai": OC.SRA32,
    "and": OC.AND32, "andi": OC.AND32, "or": OC.OR32, "ori": OC.OR32,
    "xor": OC.XOR32, "xori": OC.XOR32,
    "ne": OC.NE32, "nei": OC.NE32, "eq": OC.EQ32, "eqi": OC.EQ32,
    "feadd": OC.ADD, "fesub": OC.SUB, "femul": OC.MUL,
    "write": OC.WRITE,
}

_PLAIN_ABC = {
    "add", "sub", "mul", "mulhs", "mulhu", "div", "sdiv", "lt", "lte", "shl",
    "shr", "sra", "beq", "bne", "and", "or", "xor", "ne", "eq", "jal",
    "jalv", "slt", "sle", "feadd", "fesub", "femul",
}
_IMM_ABC = {
    "addi", "subi", "muli", "mulhsi", "mulhui", "divi", "sdivi", "lti",
    "ltei", "shli", "shri", "srai", "beqi", "bnei", "andi", "ori", "xori",
    "nei", "eqi", "slti", "slei",
}
_LEFT_IMM = {"ilt", "ilte", "islt", "isle"}

_LABEL_RE = re.compile(r"^([^:\s][^:]*):\s*$")


class AssemblyError(Exception):
    pass


def _parse_lines(text: str):
    for raw in text.split("\n"):
        line = raw.split(";")[0].strip()
        if not line:
            continue
        yield line


def assemble(text: str) -> bytes:
    """Assemble to raw machine code (24 bytes/instruction, LE)."""
    # first pass: label byte offsets
    labels = {}
    pc = 0
    for line in _parse_lines(text):
        m = _LABEL_RE.match(line)
        if m:
            labels[m.group(1).strip()] = BYTES_PER_INSTR * pc
        else:
            pc += 1

    out = bytearray()
    for line in _parse_lines(text):
        if _LABEL_RE.match(line):
            continue
        parts = line.split(None, 1)
        mnemonic = parts[0]
        if mnemonic not in _MNEMONIC_OPCODES:
            raise AssemblyError(f"Unknown mnemonic {mnemonic}")
        operands = []
        if len(parts) > 1:
            for tok in re.split(r",\s*", parts[1].strip()):
                tok = tok.strip()
                if not tok:
                    continue
                if tok.endswith("(fp)"):
                    operands.append(int(tok[: -len("(fp)")]))
                elif tok in labels:
                    operands.append(labels[tok])
                else:
                    operands.append(int(tok))

        # normalize operand counts (assembler/src/lib.rs:113-148)
        if mnemonic in ("lw", "loadu8", "loads8"):
            operands.insert(1, 0)
            operands += [0, 0]
        elif mnemonic in ("sw", "storeu8"):
            operands.insert(0, 0)
            operands += [0, 0]
        elif mnemonic in ("imm32", "write"):
            pass
        elif mnemonic == "stop":
            operands += [0] * 5
        elif mnemonic in _PLAIN_ABC:
            operands += [0, 0]
        elif mnemonic in _IMM_ABC:
            operands += [0, 1]
        elif mnemonic in _LEFT_IMM:
            operands += [1, 0]
        elif mnemonic == "advread":
            operands += [0] * 4
        else:
            raise AssemblyError(f"Unknown mnemonic {mnemonic}")

        if len(operands) != 5:
            raise AssemblyError(
                f"bad operand count for {mnemonic}: {operands}"
            )
        out += struct.pack("<I", _MNEMONIC_OPCODES[mnemonic])
        out += struct.pack("<5i", *operands)
    return bytes(out)
