"""Word (4-byte big-endian memory cell) semantics on host python ints.

Counterpart of valida_tpu/core/word.py, an exact mirror of the Rust
`machine/src/core.rs`: words are stored big-endian
(byte[0] is the most significant); u32 arithmetic with the reference's
wrapping / signed conventions.  All helpers take/return u32 python ints or
4-tuples of byte ints.
"""

from __future__ import annotations

MASK32 = 0xFFFFFFFF


# -- u32 arithmetic (wrapping where the reference wraps) ---------------------


