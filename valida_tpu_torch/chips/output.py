"""Output chip + WRITE instruction
(counterpart of valida_tpu/chips/output.py; mirrors the Rust
`output/src/{lib,columns,stark}.rs`), with the intended-design fixes
the archived reference leaves dangling:

* WRITE pushes a bus-op-*with-memory* (the reference defines
  `push_bus_op_with_memory` but never calls it, leaving the general bus
  unbalanced for any output: CPU sends clk_or_zero=0 while the output chip
  receives clk).
* The output trace stores the full written word so the 12 channel-value
  fields of the general-bus message match the CPU side exactly; the output
  byte remains the word's low byte.
* Row order (= tape order) is PROVEN: each clk delta is decomposed into
  4 range-checked base-256 limbs on the global range bus (top limb sent
  as 4*limb, bounding deltas to 2^30).  The reference constrains diff and
  counter columns but never populates or range-binds them
  (`output/src/stark.rs:21-40`, local sends commented out) — without the
  range check a prover could permute the output rows, i.e. reorder the
  output tape.  This replaces the reference's dummy-row machinery
  (`output/src/lib.rs:37-97`), whose row count is O(clk gap / table
  length).
"""

from __future__ import annotations

import numpy as np

from ..air.types import VPCol, Interaction
from ..core import opcodes as OC
from ..core.word import u32_to_bytes, MASK32
from ..field import babybear as bb
from .chip import Chip

CLK = 0
VALUE = [1, 2, 3, 4]  # full word (big-endian byte columns)
IS_REAL = 5
DELTA = [6, 7, 8, 9]  # base-256 limbs (LE) of the clk delta; top limb < 64
OPCODE = 10
NUM_OUTPUT_COLS = 11


class OutputChip(Chip):
    name = "output"

    def __init__(self):
        self.values: list[tuple[int, int]] = []  # (clk, word)

    def bytes(self) -> bytes:
        return bytes(u32_to_bytes(w)[3] for _clk, w in self.values)

    def width(self):
        return NUM_OUTPUT_COLS

    def _deltas(self, n2):
        clks = [clk for clk, _w in self.values]
        deltas = [b - a for a, b in zip(clks, clks[1:])]
        assert all(0 <= d < (1 << 30) for d in deltas)
        # padding rows repeat the last clk: delta 0
        return deltas + [0] * (n2 - len(deltas))

    def register_range_checks(self, machine):
        """Range-bus multiplicities for the clk-delta limbs (one 4-limb
        message per row, padding included)."""
        n = len(self.values)
        n2 = 1 << max((n - 1).bit_length(), 0) if n else 1
        r = machine.range()
        for d in self._deltas(n2):
            for k in range(3):
                v = (d >> (8 * k)) & 0xFF
                r.count[v] = r.count.get(v, 0) + 1
            v = 4 * ((d >> 24) & 0xFF)
            r.count[v] = r.count.get(v, 0) + 1

    def generate_trace(self, machine):
        n = len(self.values)
        n2 = 1 << max((n - 1).bit_length(), 0) if n else 1
        rows = np.zeros((n2, NUM_OUTPUT_COLS), dtype=np.uint32)
        for i, (clk, word) in enumerate(self.values):
            rows[i, CLK] = clk % bb.P
            for k, byte in enumerate(u32_to_bytes(word)):
                rows[i, VALUE[k]] = byte
            rows[i, IS_REAL] = 1
            rows[i, OPCODE] = OC.WRITE
        if n:
            # padding rows carry the last clk so deltas stay 0
            rows[n:, CLK] = rows[n - 1, CLK]
        for i, d in enumerate(self._deltas(n2)[: n2 - 1]):
            for k in range(4):
                rows[i, DELTA[k]] = (d >> (8 * k)) & 0xFF
        return rows

    def global_receives(self, machine):
        fields = [VPCol.single_main(OPCODE)]
        fields += [VPCol.single_main(VALUE[i]) for i in range(4)]  # channel 0
        fields += [VPCol.const(0)] * 8  # channels 1, 2 unused by WRITE
        fields.append(VPCol.single_main(CLK))
        return [
            Interaction(fields=fields, count=VPCol.single_main(IS_REAL),
                        bus=machine.general_bus())
        ]

    def global_sends(self, machine):
        sends = []
        for k in range(3):
            sends.append(Interaction(
                fields=[VPCol.single_main(DELTA[k])], count=VPCol.one(),
                bus=machine.range_bus()))
        sends.append(Interaction(
            fields=[VPCol([(("main", DELTA[3]), 4)])], count=VPCol.one(),
            bus=machine.range_bus()))
        return sends

    def eval(self, b):
        local = b.main_local
        nxt = b.main_next
        one = 1
        b.assert_bool(local[IS_REAL])
        delta = (local[DELTA[0]] + 256 * local[DELTA[1]]
                 + 65536 * local[DELTA[2]] + 16777216 * local[DELTA[3]])
        b.when_transition().assert_eq(delta, nxt[CLK] - local[CLK])
        # real rows are a prefix: once padding starts it never ends
        b.when_transition().when(one - local[IS_REAL]).assert_zero(
            nxt[IS_REAL]
        )
        b.when(local[IS_REAL]).assert_eq(local[OPCODE], OC.WRITE)


def ex_write(m, ops):
    """WRITE instruction (output/src/lib.rs:146-173)."""
    cpu = m.cpu()
    clk = cpu.clock
    ra = (cpu.fp + ops.b()) & MASK32
    value = m.mem().read(clk, ra, True, cpu.pc, OC.WRITE, 0)
    m.output().values.append((clk, value))
    cpu.push_bus_op_with_memory(None, OC.WRITE, ops)
    assert ops.is_imm() == 1
    assert ops.c() == 0
