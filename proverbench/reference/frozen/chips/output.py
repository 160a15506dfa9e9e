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


from ..air.types import VPCol, Interaction
from ..core import opcodes as OC
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


    def width(self):
        return NUM_OUTPUT_COLS


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


