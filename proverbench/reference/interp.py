"""A plain interpreter of the guest programs' instructions: Valida's
semantics for the opcodes the benchmark's programs use, on a dict of
32-bit cells, with nothing of the prover.  It gives a job's final memory
and its cycle count (STOP included), which the port's execution must
equal.

Operands are offsets from the frame pointer fp; an ALU instruction writes
[fp+a] = [fp+b] op ([fp+c], or c itself where e == 1); IMM32 writes the
word of its bytes b..e; a branch compares [fp+b] with [fp+c] (or c where
e == 1) and jumps to the byte address a; JAL saves the return address at
[fp+a], jumps to b and moves fp by c; JALV jumps to [fp+b] and moves fp by
[fp+c].  Shift amounts are taken mod 32, as the Shift32 chip's gadget
does."""

from __future__ import annotations

BYTES_PER_INSTR = 24
M32 = 0xFFFFFFFF


def _signed(v: int) -> int:
    return v - (1 << 32) if v & 0x80000000 else v


def _div(b: int, c: int) -> int:
    if c == 0:
        raise ZeroDivisionError("DIV32 by zero")
    return b // c


ALU = {
    "ADD32": lambda b, c: (b + c) & M32,
    "SUB32": lambda b, c: (b - c) & M32,
    "MUL32": lambda b, c: (b * c) & M32,
    "DIV32": _div,
    "SHL32": lambda b, c: (b << (c & 31)) & M32,
    "SHR32": lambda b, c: b >> (c & 31),
    "AND32": lambda b, c: b & c,
    "OR32": lambda b, c: b | c,
    "XOR32": lambda b, c: b ^ c,
    "LT32": lambda b, c: int(b < c),
    "LTE32": lambda b, c: int(b <= c),
    "SLT32": lambda b, c: int(_signed(b) < _signed(c)),
    "SLE32": lambda b, c: int(_signed(b) <= _signed(c)),
    "EQ32": lambda b, c: int(b == c),
    "NE32": lambda b, c: int(b != c),
}


def run(instructions: list, fp: int, max_cycles: int = 1 << 32
        ) -> tuple[dict, int]:
    """instructions: [(opcode name, (a, b, c, d, e))] -> (final memory
    {address: word}, cycles)."""
    mem: dict = {}
    pc = cycles = 0
    while True:
        if cycles >= max_cycles:
            raise RuntimeError(f"no STOP within {max_cycles} cycles")
        op, (a, b, c, d, e) = instructions[pc]
        cycles += 1
        if op in ALU:
            rhs = c & M32 if e == 1 else mem.get((fp + c) & M32, 0)
            mem[(fp + a) & M32] = ALU[op](mem.get((fp + b) & M32, 0), rhs)
            pc += 1
        elif op == "IMM32":
            mem[(fp + a) & M32] = (b << 24 | c << 16 | d << 8 | e) & M32
            pc += 1
        elif op in ("BEQ", "BNE"):
            lhs = mem.get((fp + b) & M32, 0)
            rhs = c & M32 if e == 1 else mem.get((fp + c) & M32, 0)
            pc = (a & M32) // BYTES_PER_INSTR if (lhs == rhs) == (
                op == "BEQ") else pc + 1
        elif op == "JAL":
            mem[(fp + a) & M32] = BYTES_PER_INSTR * (pc + 1) & M32
            pc = (b & M32) // BYTES_PER_INSTR
            fp = (fp + c) & M32
        elif op == "JALV":
            mem[(fp + a) & M32] = BYTES_PER_INSTR * (pc + 1) & M32
            target = mem.get((fp + b) & M32, 0)
            offset = mem.get((fp + c) & M32, 0)
            pc = target // BYTES_PER_INSTR
            fp = (fp + offset) & M32
        elif op == "STOP":
            return mem, cycles
        else:
            raise ValueError(f"opcode {op} is outside the reference's set")
