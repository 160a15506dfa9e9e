"""Native BabyBear field chip (mirrors `native_field/src/*`): ADD/SUB/MUL
on field elements encoded as base-256 words.  Not part of BasicMachine's
chips (native_field/src/lib.rs note), but available for machine
composition (machine/compositions.py).

Counterpart of valida_tpu/chips/native_field.py.  Its trace is made on the
host with numpy, as in the JAX package, from its op log as arrays
(`_ops_to_arrays`), so it also takes the native core's array-mode log,
which the JAX package's chip does not.
"""

from __future__ import annotations

import numpy as np

from ..air.types import VPCol, Interaction
from ..core import opcodes as OC
from ..core.word import MASK32
from ..field import babybear as bb
from .alu import _bytes_of, _finish, _ops_to_arrays, _read_b_c
from .chip import Chip, IndexAllocator, next_pow2

_n = IndexAllocator()
NF_IN1 = _n.word()
NF_IN2 = _n.word()
NF_OUT = _n.word()
NF_IS_ADD = _n.scalar()
NF_IS_SUB = _n.scalar()
NF_IS_MUL = _n.scalar()
NUM_NATIVE_FIELD_COLS = _n.width

KINDS = ["add", "sub", "mul"]


def _word_to_field(v: int) -> int:
    return v % bb.P


def _field_to_word(f: int) -> int:
    return f & MASK32  # canonical < p < 2^31 fits a u32 word


class NativeFieldChip(Chip):
    name = "native_field"

    def __init__(self):
        self.operations = []  # (kind, a, b, c) field-encoded words

    def width(self):
        return NUM_NATIVE_FIELD_COLS

    def generate_trace(self, machine):
        kinds, a, b, c = _ops_to_arrays(self.operations, KINDS)
        n = len(a)
        rows = np.zeros((next_pow2(n), NUM_NATIVE_FIELD_COLS),
                        dtype=np.uint32)
        rows[:n, NF_IN1] = _bytes_of(b)
        rows[:n, NF_IN2] = _bytes_of(c)
        rows[:n, NF_OUT] = _bytes_of(a)
        for k, col in enumerate((NF_IS_ADD, NF_IS_SUB, NF_IS_MUL)):
            rows[:n, col] = kinds == k
        return rows

    def global_sends(self, machine):
        is_real = VPCol.sum_main([NF_IS_ADD, NF_IS_SUB, NF_IS_MUL])
        return [
            Interaction(fields=[VPCol.single_main(c)], count=is_real,
                        bus=machine.range_bus())
            for c in NF_OUT
        ]

    def global_receives(self, machine):
        opcode = VPCol(
            [(("main", NF_IS_ADD), OC.ADD), (("main", NF_IS_SUB), OC.SUB),
             (("main", NF_IS_MUL), OC.MUL)]
        )
        fields = [opcode]
        fields += [VPCol.single_main(c) for c in NF_IN1 + NF_IN2 + NF_OUT]
        return [Interaction(
            fields=fields,
            count=VPCol.sum_main([NF_IS_ADD, NF_IS_SUB, NF_IS_MUL]),
            bus=machine.general_bus())]

    def eval(self, b):
        local = b.main_local
        base_m = [1 << 24, 1 << 16, 1 << 8, 1]

        def reduce(cols):
            return (base_m[0] * local[cols[0]] + base_m[1] * local[cols[1]]
                    + base_m[2] * local[cols[2]] + base_m[3] * local[cols[3]])

        x = reduce(NF_IN1)
        y = reduce(NF_IN2)
        z = reduce(NF_OUT)
        b.when(local[NF_IS_ADD]).assert_eq(z, x + y)
        b.when(local[NF_IS_SUB]).assert_eq(z, x - y)
        b.when(local[NF_IS_MUL]).assert_eq(z, x * y)


def _nf_exec(kind, opcode, fn):
    def ex(m, ops):
        b, c, imm, _ = _read_b_c(m, ops, opcode)
        a = _field_to_word(fn(_word_to_field(b), _word_to_field(c)))
        m.native_field().operations.append((kind, a, b, c))
        _finish(m, ops, opcode, a, imm)

    return ex


ex_fadd = _nf_exec("add", OC.ADD, lambda x, y: (x + y) % bb.P)
ex_fsub = _nf_exec("sub", OC.SUB, lambda x, y: (x - y) % bb.P)
ex_fmul = _nf_exec("mul", OC.MUL, lambda x, y: (x * y) % bb.P)
