"""ISA opcode numbering (mirrors the Rust `opcodes/src/lib.rs`).

Counterpart of valida_tpu/core/opcodes.py."""

BYTES_PER_INSTR = 24

# core
LOAD32 = 1
STORE32 = 2
JAL = 3
JALV = 4
BEQ = 5
BNE = 6
IMM32 = 7
STOP = 8
READ_ADVICE = 9
LOADFP = 10
LOADU8 = 11
LOADS8 = 12
STOREU8 = 13

# u32 ALU
ADD32 = 100
SUB32 = 101
MUL32 = 102
DIV32 = 103
LT32 = 104
SHL32 = 105
SHR32 = 106
AND32 = 107
OR32 = 108
XOR32 = 109
SDIV32 = 110
NE32 = 111
MULHU32 = 112
SRA32 = 113
MULHS32 = 114
LTE32 = 115
EQ32 = 116
SLT32 = 117
SLE32 = 118

# native field
ADD = 200
SUB = 201
MUL = 202

# output
WRITE = 300

OPCODE_NAMES = {
    v: k
    for k, v in list(globals().items())
    if isinstance(v, int) and k.isupper() and k not in ("BYTES_PER_INSTR",)
}
