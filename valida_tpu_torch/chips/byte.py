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

import numpy as np
import torch

from ..air.types import VPCol, Interaction
from ..core import opcodes as OC
from ..field import babybear as bb
from .chip import (Chip, IndexAllocator, assemble_columns, be_byte, grow,
                   mod_p, next_pow2, wide)
from .memory import ranks_in_clk

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


def register_range_checks(machine, src_al, dst_al, sel):
    """Execution-side range-bus multiplicities for one byte op (the
    counts this chip's range sends will claim)."""
    for al in (src_al, dst_al):
        if al >> ADDR_SPACE_BITS:
            raise ValueError(
                f"byte op address {al:#x} outside the {1 << ADDR_SPACE_BITS:#x}"
                " byte-addressable space"
            )
        q = al >> 2
        r = machine.range()
        r.range_check_value(q & 0xFF)
        r.range_check_value((q >> 8) & 0xFF)
        r.range_check_value((q >> 16) & 0xFF)
        r.range_check_value((16 * (q >> 24)) & 0xFF)
    machine.range().range_check_value(2 * (sel & 0x7F))


def byte_slots(mclk, mwrite, maddr, mvalue, is_byte):
    """((addr, value) of slot 0, 1, 2, 3), int64: the first three reads
    and the first write at each byte op's clk, in op order, from the
    memory op log in execution order and the CPU ops' byte-op flags."""
    # only the ops at byte-op clks (all of each such clk), by their rank
    # among their clk's reads or writes: each rank holds one op of every
    # byte op, in clk order (the third read, one of every STOREU8)
    at = np.flatnonzero(is_byte[mclk])
    mclk, maddr, mvalue = mclk[at], maddr[at], mvalue[at]
    mwrite = mwrite[at].astype(bool)
    read_rank = ranks_in_clk(mclk, ~mwrite)
    write_rank = ranks_in_clk(mclk, mwrite)

    def ops_of(sel):
        idx = np.flatnonzero(sel)
        return maddr[idx].astype(np.int64), mvalue[idx].astype(np.int64)

    return (ops_of(~mwrite & (read_rank == 0)),
            ops_of(~mwrite & (read_rank == 1)),
            ops_of(~mwrite & (read_rank == 2)),
            ops_of(mwrite & (write_rank == 0)))


class ByteChip(Chip):
    name = "byte"

    def width(self):
        return NUM_BYTE_COLS

    # -- trace ---------------------------------------------------------------

    def device_trace_inputs(self, machine):
        """The byte ops' compact u32 arrays, read from the CPU's and the
        memory's op arrays (there is no separate byte log): per op its kind
        (0 u8, 1 s8, 2 st), clk, pointers, aligned addresses and words.

        At a byte op's clk the memory log holds, in order, a LOADU8/LOADS8's
        reads of the pointer cell and of the aligned source word and its
        write of the destination word; a STOREU8's reads of the pointer
        cell, the aligned source word and the old destination word, and its
        write of the merged word."""
        kinds, _hi, _imm, _opc, operands, _pc, pre_fp = \
            machine.cpu().op_arrays()
        is_byte = np.isin(kinds, (1, 2, 4))
        clk = np.flatnonzero(is_byte)
        n = len(clk)
        n2 = next_pow2(n)
        is_st = kinds[clk] == 4
        kindc = np.where(is_st, 2, np.where(kinds[clk] == 2, 1, 0))
        r0, r1, r2, w0 = byte_slots(*machine.mem().op_arrays(), is_byte)
        fp = pre_fp[clk].astype(np.int64)
        opnds = operands[clk].astype(np.int64)
        srcp = np.where(is_st, fp + opnds[:, 2], r0[1]) & 0xFFFFFFFF
        srca, srcw = r1
        dstp = np.where(is_st, r0[1], fp + opnds[:, 0]) & 0xFFFFFFFF
        dsta = w0[0].copy()
        oldw = np.zeros(n, np.int64)
        dsta[is_st], oldw[is_st] = r2
        for al in (srca, dsta):
            assert (al >> ADDR_SPACE_BITS == 0).all() and (al % 4 == 0).all()
        arr = np.stack([kindc, clk % bb.P, srcp, srca, srcw, dstp, dsta,
                        oldw, w0[1]]).astype(np.uint32)
        return tuple(arr), (n, n2)

    def build_trace(self, inputs, meta):
        kindc, clk_a, srcp, srca, srcw, dstp, dsta, oldw, outw = wide(inputs)
        n, n2 = meta
        cols = {}
        for ki, col in enumerate([IS_U8, IS_S8, IS_ST]):
            cols[col] = grow((kindc == ki).to(torch.int64), n2)
        cols[CLK] = grow(clk_a, n2)
        cols[SRC_PTR] = grow(mod_p(srcp), n2)
        cols[SRC_AL] = grow(srca, n2)
        cols[B0] = grow(srcp & 1, n2)
        cols[B1] = grow((srcp >> 1) & 1, n2)
        cols[DST_PTR] = grow(mod_p(dstp), n2)
        cols[DST_AL] = grow(dsta, n2)
        cols[C0] = grow(dstp & 1, n2)
        cols[C1] = grow((dstp >> 1) & 1, n2)
        for al, q_cols in ((srca, QS), (dsta, QD)):
            q = al >> 2
            for k in range(4):
                cols[q_cols[k]] = grow((q >> (8 * k)) & 0xFF, n2)
        for w, wcols in ((srcw, SRC), (oldw, OLD), (outw, OUT)):
            for k in range(4):
                cols[wcols[k]] = grow(be_byte(w, k), n2)
        sel = (srcw >> (8 * (srcp & 3))) & 0xFF
        cols[SEL] = grow(sel, n2)
        cols[SIGN] = grow(sel >> 7, n2)
        # merged = update_byte(old, sel, 3 - (dst_ptr & 3)): byte-swap the
        # old word, then place sel at that BE slot (core.rs:48-57)
        loc = 3 - (dstp & 3)
        for j in range(4):
            cols[MERGED[j]] = grow(
                torch.where(loc == j, sel, be_byte(oldw, 3 - j)), n2)
        return assemble_columns(NUM_BYTE_COLS, n2, cols, kindc.device)

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
