"""u32 ALU chip family: Add32, Sub32, Mul32, Div32, Lt32, Com32,
Bitwise32, Shift32 — execution, trace generation, general-bus receives,
and AIR constraints.

Mirrors `alu_u32/src/*`.  Deviations (intended-design fixes, noted
inline):
  * Mul32 witnesses its r/s congruence quotients (the reference declares
    but never populates them) and pins the counter's last row to the trace
    height (the reference hard-codes 2^10, which only matches the minimum
    trace).
  * Shift32's power-of-two gadget uses the correct product form
    2^s = (1+b0)(1+3b1)(1+15b2)·byte-select (the reference's gadget
    multiplies bit*2^k factors, which vanish for any zero bit) and the
    byte-select follows the big-endian word layout.
  * SRA32 logs a Sra32 shift op (the reference logs Shr32, which would
    unbalance the general bus for SRA).

Counterpart of valida_tpu/chips/alu.py.  Each chip's op log becomes u32
numpy arrays on the host (the mul chip's congruence quotients, which need
more than 32 bits, are computed there too, as in the JAX package); the
trace is built from them by torch operations in int64 on the prover's
device.
"""

from __future__ import annotations


from ..air.types import VPCol, Interaction
from ..core import opcodes as OC
from ..field import babybear as bb
from .chip import Chip, IndexAllocator


# ---------------------------------------------------------------------------
# Add32
# ---------------------------------------------------------------------------

_a = IndexAllocator()
ADD_IN1 = _a.word()
ADD_IN2 = _a.word()
ADD_CARRY = _a.array(3)
ADD_OUT = _a.word()
ADD_IS_REAL = _a.scalar()
NUM_ADD_COLS = _a.width


class Add32Chip(Chip):
    name = "add_u32"

    def __init__(self):
        self.operations = []  # (a, b, c)

    def width(self):
        return NUM_ADD_COLS


    def global_sends(self, machine):
        return [
            Interaction(fields=[VPCol.single_main(c)],
                        count=VPCol.single_main(ADD_IS_REAL),
                        bus=machine.range_bus())
            for c in ADD_OUT
        ]

    def global_receives(self, machine):
        fields = [VPCol.const(OC.ADD32)]
        fields += [VPCol.single_main(c) for c in ADD_IN1 + ADD_IN2 + ADD_OUT]
        return [Interaction(fields=fields,
                            count=VPCol.single_main(ADD_IS_REAL),
                            bus=machine.general_bus())]

    def eval(self, b):
        local = b.main_local
        base = 256
        carries = [local[c] for c in ADD_CARRY]
        ov = [
            local[ADD_IN1[3]] + local[ADD_IN2[3]] - local[ADD_OUT[3]],
            local[ADD_IN1[2]] + local[ADD_IN2[2]] - local[ADD_OUT[2]] + carries[0],
            local[ADD_IN1[1]] + local[ADD_IN2[1]] - local[ADD_OUT[1]] + carries[1],
            local[ADD_IN1[0]] + local[ADD_IN2[0]] - local[ADD_OUT[0]] + carries[2],
        ]
        for o in ov:
            b.assert_zero(o * (o - base))
        for o, c in zip(ov[:3], carries):
            b.assert_zero(o * (c - 1) + (o - base) * c)
        for c in carries:
            b.assert_bool(c)


# ---------------------------------------------------------------------------
# Sub32
# ---------------------------------------------------------------------------

_s = IndexAllocator()
SUB_IN1 = _s.word()
SUB_IN2 = _s.word()
# the reference has 3 borrow columns and no wrap term on the top byte
# (sub/stark.rs:44-46), which makes any underflowing u32 subtraction
# unprovable; the 4th borrow is the dropped mod-2^32 wrap (intended
# design, docs/deviations.md)
SUB_BORROW = _s.array(4)
SUB_OUT = _s.word()
SUB_IS_REAL = _s.scalar()
NUM_SUB_COLS = _s.width


class Sub32Chip(Chip):
    name = "sub_u32"

    def __init__(self):
        self.operations = []

    def width(self):
        return NUM_SUB_COLS


    def global_sends(self, machine):
        return [
            Interaction(fields=[VPCol.single_main(c)],
                        count=VPCol.single_main(SUB_IS_REAL),
                        bus=machine.range_bus())
            for c in SUB_OUT
        ]

    def global_receives(self, machine):
        fields = [VPCol.const(OC.SUB32)]
        fields += [VPCol.single_main(c) for c in SUB_IN1 + SUB_IN2 + SUB_OUT]
        return [Interaction(fields=fields,
                            count=VPCol.single_main(SUB_IS_REAL),
                            bus=machine.general_bus())]

    def eval(self, b):
        local = b.main_local
        base = 256
        bw = [local[c] for c in SUB_BORROW]
        b.assert_eq(local[SUB_OUT[3]],
                    base * bw[0] + local[SUB_IN1[3]] - local[SUB_IN2[3]])
        b.assert_eq(local[SUB_OUT[2]],
                    base * bw[1] + local[SUB_IN1[2]] - local[SUB_IN2[2]] - bw[0])
        b.assert_eq(local[SUB_OUT[1]],
                    base * bw[2] + local[SUB_IN1[1]] - local[SUB_IN2[1]] - bw[1])
        b.assert_eq(local[SUB_OUT[0]],
                    base * bw[3] + local[SUB_IN1[0]] - local[SUB_IN2[0]] - bw[2])
        for x in bw:
            b.assert_bool(x)


# ---------------------------------------------------------------------------
# Mul32
# ---------------------------------------------------------------------------

_m = IndexAllocator()
MUL_IN1 = _m.word()
MUL_IN2 = _m.word()
MUL_OUT = _m.word()
MUL_R = _m.scalar()
MUL_S = _m.scalar()
MUL_IS_MUL = _m.scalar()
MUL_IS_MULHS = _m.scalar()
MUL_IS_MULHU = _m.scalar()
MUL_COUNTER = _m.scalar()
# -- high-word (MULHU/MULHS) witness: full 64-bit product carry chain --
# (the reference leaves mulhs/mulhu constraints TODO, mul/stark.rs:24;
# we prove in1*in2 = HIU*2^32 + LOW exactly over the integers with an
# 8-limb chain, then for MULHS apply the two's-complement adjustment
# hi_s = hi_u - sign(in1)*in2 - sign(in2)*in1  (mod 2^32) limb-wise)
MUL_LOW = _m.word()            # low word of the 64-bit product
MUL_HIU = _m.word()            # unsigned high word
MUL_TL = _m.array(7)           # chain carries t_k = TL + 256*(TH0 + 2*TH1)
MUL_TH0 = _m.array(7)          # (t_k <= 1019)
MUL_TH1 = _m.array(7)
MUL_U = _m.array(4)            # mulhs borrow chain, each in {0,1,2}
MUL_SA_BITS = _m.array(8)      # bits of in1's top byte (sign = bit 7)
MUL_SB_BITS = _m.array(8)      # bits of in2's top byte
NUM_MUL_COLS = _m.width

MUL_MIN_LENGTH = 1 << 10


class Mul32Chip(Chip):
    name = "mul_u32"

    def __init__(self):
        self.operations = []  # (kind, a, b, c)

    def width(self):
        return NUM_MUL_COLS


    def global_sends(self, machine):
        # intended design: outputs are byte-range-checked (the reference's
        # mul execute calls range_check but the chip never sends, leaving
        # the range bus unbalanced for any mul program)
        is_real = VPCol.sum_main([MUL_IS_MUL, MUL_IS_MULHS, MUL_IS_MULHU])
        sends = [
            Interaction(fields=[VPCol.single_main(c)], count=is_real,
                        bus=machine.range_bus())
            for c in MUL_OUT
        ]
        # high-word chain witnesses are 8-bit range-checked
        is_mulh = VPCol.sum_main([MUL_IS_MULHS, MUL_IS_MULHU])
        for c in MUL_LOW + list(MUL_TL):
            sends.append(Interaction(fields=[VPCol.single_main(c)],
                                     count=is_mulh, bus=machine.range_bus()))
        for c in MUL_HIU:
            sends.append(Interaction(fields=[VPCol.single_main(c)],
                                     count=VPCol.single_main(MUL_IS_MULHS),
                                     bus=machine.range_bus()))
        return sends

    def global_receives(self, machine):
        opcode = VPCol(
            [(("main", MUL_IS_MUL), OC.MUL32),
             (("main", MUL_IS_MULHS), OC.MULHS32),
             (("main", MUL_IS_MULHU), OC.MULHU32)]
        )
        fields = [opcode]
        fields += [VPCol.single_main(c) for c in MUL_IN1 + MUL_IN2 + MUL_OUT]
        return [Interaction(
            fields=fields,
            count=VPCol.sum_main([MUL_IS_MUL, MUL_IS_MULHS, MUL_IS_MULHU]),
            bus=machine.general_bus())]

    def eval(self, b):
        local = b.main_local
        nxt = b.main_next
        base_m = [1, 1 << 8, 1 << 16, 1 << 24]

        def pi_m(n_limbs, bases):
            acc = None
            for x in range(n_limbs):
                for y in range(n_limbs):
                    if x + y < n_limbs:
                        t = bases[x + y] * local[MUL_IN1[3 - x]] * local[MUL_IN2[3 - y]]
                        acc = t if acc is None else acc + t
            return acc

        def sigma_m(n_limbs, bases):
            acc = None
            for k in range(n_limbs):
                t = bases[k] * local[MUL_OUT[3 - k]]
                acc = t if acc is None else acc + t
            return acc

        # low-word congruence checks gated on is_mul (σ/π trick)
        is_mul = local[MUL_IS_MUL]
        b.when(is_mul).assert_eq(pi_m(4, base_m), sigma_m(4, base_m) + local[MUL_R] * 2)
        b.when(is_mul).assert_eq(
            pi_m(2, base_m), sigma_m(2, base_m) + local[MUL_S] * (1 << 16)
        )

        # -- mulhs/mulhu: exact 64-bit product via an 8-limb carry chain
        # (in1*in2 = HIU*2^32 + LOW over the integers; the reference
        # leaves these constraints TODO, mul/stark.rs:24) --
        is_mulhs = local[MUL_IS_MULHS]
        is_mulhu = local[MUL_IS_MULHU]
        is_mulh = is_mulhs + is_mulhu
        bl = [local[MUL_IN1[3 - k]] for k in range(4)]
        cl = [local[MUL_IN2[3 - k]] for k in range(4)]
        al = [local[MUL_OUT[3 - k]] for k in range(4)]
        ll = [local[MUL_LOW[3 - k]] for k in range(4)]
        hl = [local[MUL_HIU[3 - k]] for k in range(4)]
        ts = [
            local[MUL_TL[k]] + 256 * (local[MUL_TH0[k]] + 2 * local[MUL_TH1[k]])
            for k in range(7)
        ]
        for k in range(7):
            b.assert_bool(local[MUL_TH0[k]])
            b.assert_bool(local[MUL_TH1[k]])
        dl = ll + hl
        for k in range(8):
            pk = None
            for x in range(max(0, k - 3), min(3, k) + 1):
                t = bl[x] * cl[k - x]
                pk = t if pk is None else pk + t
            lhs = pk if pk is not None else 0
            if k > 0:
                lhs = lhs + ts[k - 1]
            rhs = dl[k] + (256 * ts[k] if k < 7 else 0)
            b.when(is_mulh).assert_eq(lhs, rhs)
        # mulhu: the output is the unsigned high word
        for k in range(4):
            b.when(is_mulhu).assert_eq(al[k], hl[k])
        # mulhs: out = hiu - sign(in1)*in2 - sign(in2)*in1  (mod 2^32),
        # limb-wise with borrows in {0,1,2}
        top1 = None
        top2 = None
        for k in range(8):
            b.assert_bool(local[MUL_SA_BITS[k]])
            b.assert_bool(local[MUL_SB_BITS[k]])
            t1k = (1 << k) * local[MUL_SA_BITS[k]]
            t2k = (1 << k) * local[MUL_SB_BITS[k]]
            top1 = t1k if top1 is None else top1 + t1k
            top2 = t2k if top2 is None else top2 + t2k
        b.when(is_mulhs).assert_eq(top1, local[MUL_IN1[0]])
        b.when(is_mulhs).assert_eq(top2, local[MUL_IN2[0]])
        s1 = local[MUL_SA_BITS[7]]
        s2 = local[MUL_SB_BITS[7]]
        for k in range(4):
            uk = local[MUL_U[k]]
            b.assert_zero(uk * (uk - 1) * (uk - 2))
            prev = local[MUL_U[k - 1]] if k > 0 else 0
            b.when(is_mulhs).assert_eq(
                al[k], hl[k] - s1 * cl[k] - s2 * bl[k] - prev + 256 * uk
            )

        # range-check counter (last row pinned to the actual trace height,
        # not the reference's hard-coded 2^10)
        b.when_first_row().assert_one(local[MUL_COUNTER])
        cd = nxt[MUL_COUNTER] - local[MUL_COUNTER]
        b.when_transition().assert_zero(cd * (cd - 1))
        b.when_last_row().assert_eq(local[MUL_COUNTER], b.trace_height or (1 << 10))


# ---------------------------------------------------------------------------
# Div32 — complete division argument (the reference's AIR is a stub,
# div/stark.rs:18-21; SURVEY §7 step 8 prescribes the mul-pattern proof).
#
# For is_div rows we prove b = a*c + r exactly over the integers:
#   byte-limb carry chain with range-checked carries, zero carry out of
#   byte 3, and zero high partial products (sums of nonnegative
#   range-checked byte products vanish iff every term does);
#   r < c is delegated to the Lt32 chip via a general-bus send.
#
# For is_sdiv rows (truncating signed division, core.rs `sdiv`) we reduce
# to the unsigned argument on absolute values:
#   sign bits of in1/in2 from top-byte bit decompositions; witness words
#   NB = |in1|, NC = |in2|, NA = |out|; negations are delegated to the
#   Sub32 chip as 0 - x rows (one general-bus send each, gated on
#   sign-product counts so the messages only fire when a negation
#   happens; the un-negated legs are pinned by identity constraints);
#   then the same carry chain proves NB = NA*NC + R with R < NC via Lt32,
#   and sdiff = sign(in1) xor sign(in2) selects whether out = NA or
#   out = -NA.  The carry/remainder columns are shared with is_div rows
#   (a row is exclusively one kind).
# ---------------------------------------------------------------------------

_d = IndexAllocator()
DIV_IN1 = _d.word()
DIV_IN2 = _d.word()
DIV_OUT = _d.word()
DIV_R = _d.word()       # remainder
DIV_T0 = _d.scalar()    # carry out of byte 0 (8-bit)
DIV_T1L = _d.scalar()   # carry out of byte 1: T1L + 256*T1H  (< 512)
DIV_T1H = _d.scalar()
DIV_T2L = _d.scalar()   # carry out of byte 2: T2L + 256*(T2H0 + 2*T2H1)
DIV_T2H0 = _d.scalar()
DIV_T2H1 = _d.scalar()
DIV_IS_DIV = _d.scalar()
DIV_IS_SDIV = _d.scalar()
SDIV_NB = _d.word()            # |in1|
SDIV_NC = _d.word()            # |in2|
SDIV_NA = _d.word()            # |out|
SDIV_B1_BITS = _d.array(8)     # bits of in1's top byte (sign = bit 7)
SDIV_B2_BITS = _d.array(8)     # bits of in2's top byte
SDIV_SDIFF = _d.scalar()       # sign(in1) xor sign(in2)
SDIV_NEG_B = _d.scalar()       # is_sdiv * sign(in1)   (send counts,
SDIV_NEG_C = _d.scalar()       # is_sdiv * sign(in2)    kept linear)
SDIV_NEG_A = _d.scalar()       # is_sdiv * sdiff
NUM_DIV_COLS = _d.width


class Div32Chip(Chip):
    name = "div_u32"

    def __init__(self):
        self.operations = []  # (kind, a, b, c)

    def width(self):
        return NUM_DIV_COLS


    def global_sends(self, machine):
        # intended design: see Mul32Chip.global_sends
        is_real = VPCol.sum_main([DIV_IS_DIV, DIV_IS_SDIV])
        sends = [
            Interaction(fields=[VPCol.single_main(c)], count=is_real,
                        bus=machine.range_bus())
            for c in DIV_OUT
        ]
        # remainder bytes and carry limbs are 8-bit range-checked
        for c in DIV_R + [DIV_T0, DIV_T1L, DIV_T2L]:
            sends.append(
                Interaction(fields=[VPCol.single_main(c)], count=is_real,
                            bus=machine.range_bus())
            )
        # |out| bytes when a negation row consumes them (otherwise they
        # are pinned to the already-checked OUT bytes)
        for c in SDIV_NA:
            sends.append(
                Interaction(fields=[VPCol.single_main(c)],
                            count=VPCol.single_main(SDIV_NEG_A),
                            bus=machine.range_bus())
            )
        # r < divisor delegated to the Lt32 chip (shift-style delegation):
        # divisor is in2 on div rows, |in2| on sdiv rows
        for r_cols, d_cols, count_col in (
            (DIV_R, DIV_IN2, DIV_IS_DIV),
            (DIV_R, SDIV_NC, DIV_IS_SDIV),
        ):
            fields = [VPCol.const(OC.LT32)]
            fields += [VPCol.single_main(c) for c in r_cols + d_cols]
            fields += [VPCol.const(0)] * 3 + [VPCol.const(1)]
            sends.append(
                Interaction(fields=fields, count=VPCol.single_main(count_col),
                            bus=machine.general_bus())
            )
        # negations 0 - x delegated to the Sub32 chip
        for in_cols, out_cols, count_col in (
            (DIV_IN1, SDIV_NB, SDIV_NEG_B),
            (DIV_IN2, SDIV_NC, SDIV_NEG_C),
            (SDIV_NA, DIV_OUT, SDIV_NEG_A),
        ):
            fields = [VPCol.const(OC.SUB32)] + [VPCol.const(0)] * 4
            fields += [VPCol.single_main(c) for c in in_cols + out_cols]
            sends.append(
                Interaction(fields=fields, count=VPCol.single_main(count_col),
                            bus=machine.general_bus())
            )
        return sends

    def global_receives(self, machine):
        opcode = VPCol(
            [(("main", DIV_IS_DIV), OC.DIV32), (("main", DIV_IS_SDIV), OC.SDIV32)]
        )
        fields = [opcode]
        fields += [VPCol.single_main(c) for c in DIV_IN1 + DIV_IN2 + DIV_OUT]
        return [Interaction(
            fields=fields,
            count=VPCol.sum_main([DIV_IS_DIV, DIV_IS_SDIV]),
            bus=machine.general_bus())]

    def eval(self, b):
        local = b.main_local
        is_div = local[DIV_IS_DIV]
        is_sdiv = local[DIV_IS_SDIV]
        b.assert_bool(is_div)
        b.assert_bool(is_sdiv)
        b.assert_bool(is_div + is_sdiv)
        b.assert_bool(local[DIV_T1H])
        b.assert_bool(local[DIV_T2H0])
        b.assert_bool(local[DIV_T2H1])

        rb = [local[DIV_R[3 - i]] for i in range(4)]
        t0 = local[DIV_T0]
        t1 = local[DIV_T1L] + 256 * local[DIV_T1H]
        t2 = local[DIV_T2L] + 256 * (local[DIV_T2H0] + 2 * local[DIV_T2H1])

        def chain(gate, out_cols, in1_cols, in2_cols):
            # b = a*c + r over the integers, LSB-first byte limbs (word
            # columns are big-endian); shared carry/remainder witnesses
            ab = [local[out_cols[3 - i]] for i in range(4)]
            bbt = [local[in1_cols[3 - i]] for i in range(4)]
            cb = [local[in2_cols[3 - i]] for i in range(4)]
            p0 = ab[0] * cb[0]
            p1 = ab[0] * cb[1] + ab[1] * cb[0]
            p2 = ab[0] * cb[2] + ab[1] * cb[1] + ab[2] * cb[0]
            p3 = ab[0] * cb[3] + ab[1] * cb[2] + ab[2] * cb[1] + ab[3] * cb[0]
            b.when(gate).assert_zero(p0 + rb[0] - bbt[0] - 256 * t0)
            b.when(gate).assert_zero(p1 + rb[1] + t0 - bbt[1] - 256 * t1)
            b.when(gate).assert_zero(p2 + rb[2] + t1 - bbt[2] - 256 * t2)
            b.when(gate).assert_zero(p3 + rb[3] + t2 - bbt[3])
            # no overflow: all high partial products vanish (each term is
            # a product of range-checked bytes, so the field sum is 0 iff
            # every term is 0)
            b.when(gate).assert_zero(
                ab[1] * cb[3] + ab[2] * cb[2] + ab[3] * cb[1]
            )
            b.when(gate).assert_zero(ab[2] * cb[3] + ab[3] * cb[2])
            b.when(gate).assert_zero(ab[3] * cb[3])

        chain(is_div, DIV_OUT, DIV_IN1, DIV_IN2)
        chain(is_sdiv, SDIV_NA, SDIV_NB, SDIV_NC)

        # -- signed rows: sign extraction and negation selection --
        top1 = None
        top2 = None
        for k in range(8):
            b.assert_bool(local[SDIV_B1_BITS[k]])
            b.assert_bool(local[SDIV_B2_BITS[k]])
            t1k = (1 << k) * local[SDIV_B1_BITS[k]]
            t2k = (1 << k) * local[SDIV_B2_BITS[k]]
            top1 = t1k if top1 is None else top1 + t1k
            top2 = t2k if top2 is None else top2 + t2k
        b.when(is_sdiv).assert_eq(top1, local[DIV_IN1[0]])
        b.when(is_sdiv).assert_eq(top2, local[DIV_IN2[0]])
        s1 = local[SDIV_B1_BITS[7]]
        s2 = local[SDIV_B2_BITS[7]]
        b.when(is_sdiv).assert_eq(
            local[SDIV_SDIFF], s1 + s2 - 2 * s1 * s2
        )
        b.assert_eq(local[SDIV_NEG_B], is_sdiv * s1)
        b.assert_eq(local[SDIV_NEG_C], is_sdiv * s2)
        b.assert_eq(local[SDIV_NEG_A], is_sdiv * local[SDIV_SDIFF])
        # un-negated legs are identities (negated legs are closed by the
        # Sub32 delegation sends); counts is_sdiv - NEG_x = is_sdiv*(1-s)
        for k in range(4):
            b.when(is_sdiv - local[SDIV_NEG_B]).assert_eq(
                local[SDIV_NB[k]], local[DIV_IN1[k]]
            )
            b.when(is_sdiv - local[SDIV_NEG_C]).assert_eq(
                local[SDIV_NC[k]], local[DIV_IN2[k]]
            )
            b.when(is_sdiv - local[SDIV_NEG_A]).assert_eq(
                local[SDIV_NA[k]], local[DIV_OUT[k]]
            )


# ---------------------------------------------------------------------------
# Lt32 (LT/LTE/SLT/SLE)
# ---------------------------------------------------------------------------

_l = IndexAllocator()
LT_IN1 = _l.word()
LT_IN2 = _l.word()
LT_BYTE_FLAG = _l.array(4)
LT_BITS = _l.array(9)
LT_OUT = _l.scalar()
LT_MULT = _l.scalar()
LT_IS_LT = _l.scalar()
LT_IS_LTE = _l.scalar()
LT_IS_SLT = _l.scalar()
LT_IS_SLE = _l.scalar()
LT_DIFF_INV = _l.scalar()
LT_TOP_BITS_1 = _l.array(8)
LT_TOP_BITS_2 = _l.array(8)
LT_DIFFERENT_SIGNS = _l.scalar()
NUM_LT_COLS = _l.width


class Lt32Chip(Chip):
    name = "lt_u32"

    def __init__(self):
        self.operations = []  # (kind, a, b, c)

    def width(self):
        return NUM_LT_COLS


    def global_receives(self, machine):
        opcode = VPCol(
            [(("main", LT_IS_LT), OC.LT32), (("main", LT_IS_LTE), OC.LTE32),
             (("main", LT_IS_SLT), OC.SLT32), (("main", LT_IS_SLE), OC.SLE32)]
        )
        fields = [opcode]
        fields += [VPCol.single_main(c) for c in LT_IN1 + LT_IN2]
        fields += [VPCol.const(0)] * 3 + [VPCol.single_main(LT_OUT)]
        return [Interaction(fields=fields, count=VPCol.single_main(LT_MULT),
                            bus=machine.general_bus())]

    def eval(self, b):
        local = b.main_local
        base_2 = [1, 2, 4, 8, 16, 32, 64, 128, 256]
        one = 1

        bit_comp = None
        for k in range(9):
            t = base_2[k] * local[LT_BITS[k]]
            bit_comp = t if bit_comp is None else bit_comp + t

        flags = [local[LT_BYTE_FLAG[i]] for i in range(4)]
        flag_sum = flags[0] + flags[1] + flags[2] + flags[3]
        b.assert_bool(flag_sum)
        b.when_ne(flags[0], one).assert_eq(local[LT_IN1[0]], local[LT_IN2[0]])
        b.when_ne(flags[0] + flags[1], one).assert_eq(
            local[LT_IN1[1]], local[LT_IN2[1]]
        )
        b.when_ne(flags[0] + flags[1] + flags[2], one).assert_eq(
            local[LT_IN1[2]], local[LT_IN2[2]]
        )
        b.when_ne(flag_sum, one).assert_eq(local[LT_IN1[3]], local[LT_IN2[3]])
        b.when_ne(flag_sum, one).assert_zero(bit_comp)

        for i in range(4):
            b.when(flags[i]).assert_eq(
                256 + local[LT_IN1[i]] - local[LT_IN2[i]], bit_comp
            )
            b.when(flags[i]).assert_one(
                (local[LT_IN1[i]] - local[LT_IN2[i]]) * local[LT_DIFF_INV]
            )
            b.assert_bool(flags[i])

        top1 = None
        top2 = None
        for k in range(8):
            t1 = base_2[k] * local[LT_TOP_BITS_1[k]]
            t2 = base_2[k] * local[LT_TOP_BITS_2[k]]
            top1 = t1 if top1 is None else top1 + t1
            top2 = t2 if top2 is None else top2 + t2
        b.assert_eq(top1, local[LT_IN1[0]])
        b.assert_eq(top2, local[LT_IN2[0]])

        is_signed = local[LT_IS_SLT] + local[LT_IS_SLE]
        is_unsigned = one - is_signed
        same_sign = one - local[LT_DIFFERENT_SIGNS]
        are_equal = one - flag_sum

        b.when(is_unsigned).assert_zero(local[LT_DIFFERENT_SIGNS])
        b.when(is_signed).when_ne(
            local[LT_TOP_BITS_1[7]], local[LT_TOP_BITS_2[7]]
        ).assert_one(local[LT_DIFFERENT_SIGNS])
        b.when(local[LT_DIFFERENT_SIGNS]).assert_one(flags[0])
        b.when(local[LT_DIFFERENT_SIGNS]).assert_one(
            local[LT_TOP_BITS_1[7]] + local[LT_TOP_BITS_2[7]]
        )

        b.assert_bool(local[LT_IS_LT])
        b.assert_bool(local[LT_IS_LTE])
        b.assert_bool(local[LT_IS_SLT])
        b.assert_bool(local[LT_IS_SLE])
        b.assert_bool(local[LT_IS_LT] + local[LT_IS_LTE] + local[LT_IS_SLT]
                      + local[LT_IS_SLE])

        # output truth table
        b.when(local[LT_BITS[8]]).when(is_unsigned + same_sign).assert_zero(
            local[LT_OUT]
        )
        b.when(local[LT_BITS[8]]).when(local[LT_DIFFERENT_SIGNS]).assert_one(
            local[LT_OUT]
        )
        b.when_ne(local[LT_BITS[8]] + are_equal, one).when(
            is_unsigned + same_sign
        ).assert_one(local[LT_OUT])
        b.when_ne(local[LT_BITS[8]] + are_equal, one).when(
            local[LT_DIFFERENT_SIGNS]
        ).assert_zero(local[LT_OUT])
        b.when(are_equal).when(local[LT_IS_LTE] + local[LT_IS_SLE]).assert_one(
            local[LT_OUT]
        )
        b.when(are_equal).when(local[LT_IS_LT] + local[LT_IS_SLT]).assert_zero(
            local[LT_OUT]
        )

        for k in range(9):
            b.assert_bool(local[LT_BITS[k]])
        for k in range(8):
            b.assert_bool(local[LT_TOP_BITS_1[k]])
            b.assert_bool(local[LT_TOP_BITS_2[k]])


# ---------------------------------------------------------------------------
# Com32 (EQ32 / NE32)
# ---------------------------------------------------------------------------

_c = IndexAllocator()
COM_IN1 = _c.word()
COM_IN2 = _c.word()
COM_DIFF = _c.scalar()
COM_DIFF_INV = _c.scalar()
COM_NOT_EQUAL = _c.scalar()
COM_OUT = _c.scalar()
COM_IS_NE = _c.scalar()
COM_IS_EQ = _c.scalar()
NUM_COM_COLS = _c.width


class Com32Chip(Chip):
    name = "com_u32"

    def __init__(self):
        self.operations = []  # (kind, a, b, c)

    def width(self):
        return NUM_COM_COLS


    def global_receives(self, machine):
        opcode = VPCol(
            [(("main", COM_IS_NE), OC.NE32), (("main", COM_IS_EQ), OC.EQ32)]
        )
        fields = [opcode]
        fields += [VPCol.single_main(c) for c in COM_IN1 + COM_IN2]
        fields += [VPCol.const(0)] * 3 + [VPCol.single_main(COM_OUT)]
        return [Interaction(
            fields=fields, count=VPCol.sum_main([COM_IS_NE, COM_IS_EQ]),
            bus=machine.general_bus())]

    def eval(self, b):
        local = b.main_local
        one = 1
        diff = None
        for i in range(4):
            d = local[COM_IN1[i]] - local[COM_IN2[i]]
            sq = d * d
            diff = sq if diff is None else diff + sq
        b.assert_eq(local[COM_DIFF], diff)
        b.assert_bool(local[COM_NOT_EQUAL])
        b.assert_eq(local[COM_NOT_EQUAL], local[COM_DIFF] * local[COM_DIFF_INV])
        b.assert_zero((one - local[COM_NOT_EQUAL]) * local[COM_DIFF])
        b.assert_bool(local[COM_IS_NE])
        b.assert_bool(local[COM_IS_EQ])
        b.assert_bool(local[COM_IS_NE] + local[COM_IS_EQ])
        b.assert_eq(
            local[COM_OUT],
            local[COM_IS_NE] * local[COM_NOT_EQUAL]
            + local[COM_IS_EQ] * (one - local[COM_NOT_EQUAL]),
        )


# ---------------------------------------------------------------------------
# Bitwise32 (AND/OR/XOR)
# ---------------------------------------------------------------------------

_bw = IndexAllocator()
BW_IN1 = _bw.word()
BW_IN2 = _bw.word()
BW_BITS_1 = [_bw.array(8) for _ in range(4)]
BW_BITS_2 = [_bw.array(8) for _ in range(4)]
BW_OUT = _bw.word()
BW_IS_AND = _bw.scalar()
BW_IS_OR = _bw.scalar()
BW_IS_XOR = _bw.scalar()
NUM_BITWISE_COLS = _bw.width


class Bitwise32Chip(Chip):
    name = "bitwise_u32"

    def __init__(self):
        self.operations = []  # (kind, a, b, c)

    def width(self):
        return NUM_BITWISE_COLS


    def global_receives(self, machine):
        opcode = VPCol(
            [(("main", BW_IS_AND), OC.AND32), (("main", BW_IS_OR), OC.OR32),
             (("main", BW_IS_XOR), OC.XOR32)]
        )
        fields = [opcode]
        fields += [VPCol.single_main(c) for c in BW_IN1 + BW_IN2 + BW_OUT]
        return [Interaction(
            fields=fields,
            count=VPCol.sum_main([BW_IS_AND, BW_IS_OR, BW_IS_XOR]),
            bus=machine.general_bus())]

    def eval(self, b):
        local = b.main_local
        base_2 = [1, 2, 4, 8, 16, 32, 64, 128]
        for i in range(4):
            byte1 = None
            byte2 = None
            band = None
            for k in range(8):
                t1 = base_2[k] * local[BW_BITS_1[i][k]]
                t2 = base_2[k] * local[BW_BITS_2[i][k]]
                ta = base_2[k] * local[BW_BITS_1[i][k]] * local[BW_BITS_2[i][k]]
                byte1 = t1 if byte1 is None else byte1 + t1
                byte2 = t2 if byte2 is None else byte2 + t2
                band = ta if band is None else band + ta
            b.assert_eq(local[BW_IN1[i]], byte1)
            b.assert_eq(local[BW_IN2[i]], byte2)
            bor = byte1 + byte2 - band
            bxor = byte1 + byte2 - 2 * band
            b.when(local[BW_IS_AND]).assert_eq(band, local[BW_OUT[i]])
            b.when(local[BW_IS_OR]).assert_eq(bor, local[BW_OUT[i]])
            b.when(local[BW_IS_XOR]).assert_eq(bxor, local[BW_OUT[i]])
            for k in range(8):
                b.assert_bool(local[BW_BITS_1[i][k]])
                b.assert_bool(local[BW_BITS_2[i][k]])
        b.assert_bool(local[BW_IS_AND])
        b.assert_bool(local[BW_IS_OR])
        b.assert_bool(local[BW_IS_XOR])
        b.assert_bool(local[BW_IS_AND] + local[BW_IS_OR] + local[BW_IS_XOR])


# ---------------------------------------------------------------------------
# Shift32 (SHL/SHR/SRA via mul/div delegation)
# ---------------------------------------------------------------------------

_sh = IndexAllocator()
SH_IN1 = _sh.word()
SH_IN2 = _sh.word()
SH_OUT = _sh.word()
SH_BITS_2 = _sh.array(8)
SH_TEMP_1 = _sh.scalar()
SH_POW = _sh.word()
SH_IS_SHL = _sh.scalar()
SH_IS_SHR = _sh.scalar()
SH_IS_SRA = _sh.scalar()
SH_TOP_BITS_1 = _sh.array(8)  # bit decomposition of in1's top byte
SH_SRA_NEG = _sh.scalar()     # is_sra * sign(in1)  (linear send count)
NUM_SHIFT_COLS = _sh.width


class Shift32Chip(Chip):
    name = "shift_u32"

    def __init__(self):
        self.operations = []  # (kind, a, b, c)

    def width(self):
        return NUM_SHIFT_COLS


    def global_sends(self, machine):
        # Delegation (reference shift/stark.rs:55-69 re-sends SHL->MUL32,
        # SHR->DIV32, SRA->SDIV32).  The reference's SRA->SDIV32 leg is
        # internally inconsistent: its SRA executes an arithmetic shift
        # (floor division, core.rs `sra`) while SDIV truncates toward zero
        # (core.rs `sdiv`) — the two differ for negative odd inputs.  We
        # instead use the two's-complement identity
        #     sra(b, s) = ~( ~b >> s )          for sign(b) = 1
        #     sra(b, s) =    b >> s             for sign(b) = 0
        # and delegate BOTH legs to the fully-constrained unsigned Div32
        # row: the complemented message fields 255 - byte are linear in the
        # columns, so no extra witness beyond sign(in1) is needed
        # (docs/deviations.md).
        opcode = VPCol(
            [(("main", SH_IS_SHL), OC.MUL32), (("main", SH_IS_SHR), OC.DIV32),
             (("main", SH_IS_SRA), OC.DIV32)]
        )
        fields = [opcode]
        fields += [VPCol.single_main(c) for c in SH_IN1 + SH_POW + SH_OUT]
        direct_count = VPCol(
            [(("main", SH_IS_SHL), 1), (("main", SH_IS_SHR), 1),
             (("main", SH_IS_SRA), 1), (("main", SH_SRA_NEG), bb.P - 1)]
        )
        sends = [Interaction(fields=fields, count=direct_count,
                             bus=machine.general_bus())]
        comp_fields = [VPCol.const(OC.DIV32)]
        comp_fields += [VPCol([(("main", c), bb.P - 1)], 255) for c in SH_IN1]
        comp_fields += [VPCol.single_main(c) for c in SH_POW]
        comp_fields += [VPCol([(("main", c), bb.P - 1)], 255) for c in SH_OUT]
        sends.append(Interaction(fields=comp_fields,
                                 count=VPCol.single_main(SH_SRA_NEG),
                                 bus=machine.general_bus()))
        return sends

    def global_receives(self, machine):
        opcode = VPCol(
            [(("main", SH_IS_SHL), OC.SHL32), (("main", SH_IS_SHR), OC.SHR32),
             (("main", SH_IS_SRA), OC.SRA32)]
        )
        fields = [opcode]
        fields += [VPCol.single_main(c) for c in SH_IN1 + SH_IN2 + SH_OUT]
        return [Interaction(
            fields=fields,
            count=VPCol.sum_main([SH_IS_SHL, SH_IS_SHR, SH_IS_SRA]),
            bus=machine.general_bus())]

    def eval(self, b):
        local = b.main_local
        one = 1
        bit_base = [1, 2, 4, 8, 16, 32, 64, 128]
        byte2 = None
        for k in range(8):
            t = bit_base[k] * local[SH_BITS_2[k]]
            byte2 = t if byte2 is None else byte2 + t
        b.assert_eq(local[SH_IN2[3]], byte2)
        for k in range(8):
            b.assert_bool(local[SH_BITS_2[k]])

        # 2^(s mod 8) = (1 + b0)(1 + 3 b1)(1 + 15 b2)  [fixes the broken
        # reference gadget, shift/stark.rs:46-49]
        bits = [local[SH_BITS_2[k]] for k in range(5)]
        temp = (one + bits[0]) * (one + 3 * bits[1]) * (one + 15 * bits[2])
        b.assert_eq(local[SH_TEMP_1], temp)
        # byte select for bits 3, 4 (big-endian word layout)
        b.assert_eq(local[SH_POW[3]],
                    local[SH_TEMP_1] * (one - bits[3]) * (one - bits[4]))
        b.assert_eq(local[SH_POW[2]], local[SH_TEMP_1] * bits[3] * (one - bits[4]))
        b.assert_eq(local[SH_POW[1]], local[SH_TEMP_1] * (one - bits[3]) * bits[4])
        b.assert_eq(local[SH_POW[0]], local[SH_TEMP_1] * bits[3] * bits[4])

        b.assert_bool(local[SH_IS_SHL])
        b.assert_bool(local[SH_IS_SHR])
        b.assert_bool(local[SH_IS_SRA])
        b.assert_bool(local[SH_IS_SHL] + local[SH_IS_SHR] + local[SH_IS_SRA])

        # sign(in1) for the SRA complement delegation
        top1 = None
        for k in range(8):
            t = bit_base[k] * local[SH_TOP_BITS_1[k]]
            top1 = t if top1 is None else top1 + t
            b.assert_bool(local[SH_TOP_BITS_1[k]])
        b.assert_eq(top1, local[SH_IN1[0]])
        b.assert_eq(local[SH_SRA_NEG],
                    local[SH_IS_SRA] * local[SH_TOP_BITS_1[7]])


