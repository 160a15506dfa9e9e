"""Byte-access chip: proves LOADU8 / LOADS8 / STOREU8 byte extraction,
sign extension, and read-modify-write merging, delegated from the CPU.

This chip has no counterpart in the reference — there, byte-op CPU memory
channels are entirely unconstrained (`cpu/src/stark.rs` never mentions the
byte flags) and STOREU8 needs 3 reads + 1 write against 3 channels
(`cpu/src/lib.rs:646-697`), so the intended design could never have been
balanced.  Following the Shift32 delegation pattern (`shift/src/stark.rs`),
the CPU instead sends one message per byte op on a dedicated byte bus and
this chip proves the byte arithmetic with rows that exist only for byte
ops:

* ``src_ptr = src_aligned + (src_ptr mod 4)`` with the aligned address
  proven a multiple of 4 via a base-256 decomposition of ``src_aligned/4``
  (8-bit range bus; top limb < 16, bounding byte-addressable memory to
  2^30); same for the destination;
* the addressed byte is selected from the big-endian word via the
  two-bit index (slot ``3 - (ptr & 3)``, `machine/src/core.rs:14-25`);
* LOADU8 writes ``[0,0,0,byte]``; LOADS8 writes ``[s,s,s,byte]`` with the
  sign byte proven by an 8-bit range check of ``2*(byte - 128*sign)``;
* STOREU8's merge read of the old destination word is logged in execution
  (`read_or_init`, mirroring cpu/src/lib.rs:687) and THIS chip sends it to
  the memory bus (the CPU's three channels carry the other two reads and
  the final write); the merged word reproduces `Word::update_byte`'s
  byte-swap semantics (core.rs:48-57).

Counterpart of valida_tpu/chips/byte.py: the byte ops are parsed from the
CPU and memory logs on the host; the trace is built by torch operations on
the prover's device.
"""

from __future__ import annotations


from ..air.types import VPCol, Interaction
from ..core import opcodes as OC
from ..field import babybear as bb
from .chip import Chip, IndexAllocator

_a = IndexAllocator()
IS_U8 = _a.scalar()
IS_S8 = _a.scalar()
IS_ST = _a.scalar()
CLK = _a.scalar()
SRC_PTR = _a.scalar()
SRC_AL = _a.scalar()
QS = _a.array(4)      # base-256 limbs of src_aligned / 4 (LE)
B0 = _a.scalar()      # src_ptr & 1
B1 = _a.scalar()      # (src_ptr >> 1) & 1
SRC = _a.word()       # source word (big-endian byte columns)
DST_PTR = _a.scalar()
DST_AL = _a.scalar()
QD = _a.array(4)
C0 = _a.scalar()
C1 = _a.scalar()
OLD = _a.word()       # old destination word (STOREU8 merge read)
OUT = _a.word()       # written word (CPU channel 2 value)
SEL = _a.scalar()     # the addressed byte
SIGN = _a.scalar()    # sel >> 7 (LOADS8)
MERGED = _a.word()    # update_byte(old, sel, index_of_byte(dst_ptr))
NUM_BYTE_COLS = _a.width

ADDR_SPACE_BITS = 30  # top q-limb < 16 => aligned addresses < 2^30


def _lagrange(j, x0, x1):
    """Indicator that big-endian slot j == 3 - (2*x1 + x0)."""
    if j == 3:
        return (1 - x0) * (1 - x1)
    if j == 2:
        return x0 * (1 - x1)
    if j == 1:
        return (1 - x0) * x1
    return x0 * x1


class ByteChip(Chip):
    name = "byte"

    def width(self):
        return NUM_BYTE_COLS

    # -- trace ---------------------------------------------------------------


    # -- interactions ----------------------------------------------------------

    def global_receives(self, machine):
        opcode = VPCol([
            (("main", IS_U8), OC.LOADU8),
            (("main", IS_S8), OC.LOADS8),
            (("main", IS_ST), OC.STOREU8),
        ])
        count = VPCol.sum_main([IS_U8, IS_S8, IS_ST])
        fields = [opcode, VPCol.single_main(CLK),
                  VPCol.single_main(SRC_PTR), VPCol.single_main(SRC_AL)]
        fields += [VPCol.single_main(SRC[i]) for i in range(4)]
        fields += [VPCol.single_main(DST_PTR), VPCol.single_main(DST_AL)]
        fields += [VPCol.single_main(OUT[i]) for i in range(4)]
        return [Interaction(fields=fields, count=count,
                            bus=machine.byte_bus())]

    def global_sends(self, machine):
        sends = []
        # the STOREU8 merge read, on behalf of the CPU (channel layout:
        # is_read, clk, addr, is_static_initial, value[4])
        fields = [VPCol.one(), VPCol.single_main(CLK),
                  VPCol.single_main(DST_AL), VPCol.const(0)]
        fields += [VPCol.single_main(OLD[i]) for i in range(4)]
        sends.append(Interaction(fields=fields,
                                 count=VPCol.single_main(IS_ST),
                                 bus=machine.mem_bus()))
        # alignment decompositions + the LOADS8 sign byte
        count = VPCol.sum_main([IS_U8, IS_S8, IS_ST])
        for q_cols in (QS, QD):
            for k in range(3):
                sends.append(Interaction(
                    fields=[VPCol.single_main(q_cols[k])], count=count,
                    bus=machine.range_bus()))
            sends.append(Interaction(
                fields=[VPCol([(("main", q_cols[3]), 16)])], count=count,
                bus=machine.range_bus()))
        sends.append(Interaction(
            fields=[VPCol([(("main", SEL), 2), (("main", SIGN), bb.P - 256)])],
            count=count, bus=machine.range_bus()))
        return sends

    # -- AIR -------------------------------------------------------------------

    def eval(self, b):
        local = b.main_local
        one = 1
        f_u8, f_s8, f_st = local[IS_U8], local[IS_S8], local[IS_ST]
        f_any = f_u8 + f_s8 + f_st
        for f in (f_u8, f_s8, f_st, f_any, local[B0], local[B1],
                  local[C0], local[C1], local[SIGN]):
            b.assert_bool(f)

        # pointer = aligned + 2-bit offset; aligned = 4 * (base-256 limbs),
        # limbs range-checked on the bus, top limb < 16 (no field wrap)
        for ptr, al, q_cols, x0, x1 in (
            (SRC_PTR, SRC_AL, QS, B0, B1),
            (DST_PTR, DST_AL, QD, C0, C1),
        ):
            b.assert_eq(local[ptr],
                        local[al] + 2 * local[x1] + local[x0])
            b.assert_eq(
                local[al],
                4 * (local[q_cols[0]] + 256 * local[q_cols[1]]
                     + 65536 * local[q_cols[2]]
                     + 16777216 * local[q_cols[3]]),
            )

        # byte selection from the big-endian source word
        sel_expr = None
        for j in range(4):
            term = _lagrange(j, local[B0], local[B1]) * local[SRC[j]]
            sel_expr = term if sel_expr is None else sel_expr + term
        b.assert_eq(local[SEL], sel_expr)

        # LOADU8: out = [0, 0, 0, sel]
        for j in range(3):
            b.when(f_u8).assert_zero(local[OUT[j]])
        b.when(f_u8).assert_eq(local[OUT[3]], local[SEL])

        # LOADS8: out = [255s, 255s, 255s, sel]; 2*(sel - 128*sign) is
        # range-checked to [0, 256) on the bus, pinning sign = sel >> 7
        for j in range(3):
            b.when(f_s8).assert_eq(local[OUT[j]], 255 * local[SIGN])
        b.when(f_s8).assert_eq(local[OUT[3]], local[SEL])

        # STOREU8: update_byte's byte-swap merge (core.rs:48-57) —
        # merged[j] = sel at BE slot 3-(dst&3), else old[3-j]
        for j in range(4):
            k_j = _lagrange(j, local[C0], local[C1])
            b.assert_eq(
                local[MERGED[j]],
                k_j * local[SEL] + (one - k_j) * local[OLD[3 - j]],
            )
            b.when(f_st).assert_eq(local[OUT[j]], local[MERGED[j]])
