"""8-bit range-checker chip
(counterpart of valida_tpu/chips/range.py; mirrors the Rust
`range/src/{lib,columns,stark}.rs`).

Main: (mult, counter); preprocessed: counter column.  Receives each value
on the range bus with its multiplicity.  Deviation (intended design): the
main counter is constrained to equal the preprocessed counter (the
reference's eval is a TODO).
"""

from __future__ import annotations

import numpy as np

from ..air.types import VPCol, Interaction
from .chip import Chip

MULT = 0
COUNTER = 1
NUM_RANGE_COLS = 2


class RangeCheckerChip(Chip):
    name = "range"

    def __init__(self, max_value: int = 256):
        self.max_value = max_value
        self.count: dict[int, int] = {}


    def width(self):
        return NUM_RANGE_COLS


    def preprocessed_trace(self):
        return np.arange(self.max_value, dtype=np.uint32).reshape(-1, 1)

    def global_receives(self, machine):
        return [
            Interaction(fields=[VPCol.single_main(COUNTER)],
                        count=VPCol.single_main(MULT),
                        bus=machine.range_bus())
        ]

    def eval(self, b):
        b.assert_eq(b.main_local[COUNTER], b.preprocessed_local[0])
