"""Word (4-byte big-endian memory cell) semantics on host python ints.

Counterpart of valida_tpu/core/word.py, an exact mirror of the Rust
`machine/src/core.rs`: words are stored big-endian
(byte[0] is the most significant); u32 arithmetic with the reference's
wrapping / signed conventions.  All helpers take/return u32 python ints or
4-tuples of byte ints.
"""

from __future__ import annotations

MASK32 = 0xFFFFFFFF


def u32_to_bytes(v: int):
    """u32 -> big-endian byte tuple (b0 most significant)."""
    v &= MASK32
    return ((v >> 24) & 0xFF, (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF)


def bytes_to_u32(b) -> int:
    return ((b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]) & MASK32


def to_signed(v: int) -> int:
    v &= MASK32
    return v - (1 << 32) if v >= (1 << 31) else v


def from_signed(v: int) -> int:
    return v & MASK32


def index_of_byte(addr: int) -> int:
    """Byte slot within the word for a byte address (LE addr -> BE slot)."""
    return 3 - (addr & 3)


def addr_of_word(addr: int) -> int:
    return addr & ~3


def is_mul_4(addr: int) -> bool:
    return addr % 4 == 0


def sign_extend_byte(byte: int) -> int:
    """Word::sign_extend_byte — byte in slot 3, sign fill elsewhere."""
    if byte & 0x80:
        return 0xFFFFFF00 | byte
    return byte


def update_byte(word_value: int, byte: int, loc: int) -> int:
    """Word::update_byte — NOTE the reference byte-swaps the word before
    writing the byte at big-endian slot `loc` (`core.rs:48-57`)."""
    b = u32_to_bytes(word_value)
    swapped = [b[3], b[2], b[1], b[0]]
    swapped[loc] = byte & 0xFF
    return bytes_to_u32(swapped)


# -- u32 arithmetic (wrapping where the reference wraps) ---------------------


def add_u32(a, b):
    return (a + b) & MASK32


def sub_u32(a, b):
    return (a - b) & MASK32


def mul_u32(a, b):
    return (a * b) & MASK32


def mulhs_u32(a, b):
    return (to_signed(a) * to_signed(b) >> 32) & MASK32


def mulhu_u32(a, b):
    return ((a * b) >> 32) & MASK32


def div_u32(a, b):
    return (a // b) & MASK32


def sdiv_u32(a, b):
    """Rust i32 division truncates toward zero."""
    sa, sb = to_signed(a), to_signed(b)
    q = abs(sa) // abs(sb)
    if (sa < 0) != (sb < 0):
        q = -q
    return from_signed(q)


def shl_u32(a, b):
    """Shift amount taken mod 32 — matches the Shift32 chip's 5-bit
    power-of-two gadget (the reference VM would panic for b >= 32)."""
    return (a << (b & 31)) & MASK32


def shr_u32(a, b):
    return (a >> (b & 31)) & MASK32


def sra_u32(a, b):
    return from_signed(to_signed(a) >> (b & 31))
