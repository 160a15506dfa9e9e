"""Static data chip
(counterpart of valida_tpu/chips/static_data.py; mirrors the Rust
`static_data/src/{lib,columns,stark}.rs`):
preloads ELF data sections into memory and balances the memory chip's
initial-write rows on the memory bus."""

from __future__ import annotations

import numpy as np

from ..air.types import VPCol, Interaction
from ..core.word import u32_to_bytes
from ..field import babybear as bb
from .chip import Chip

ADDR = 0
VALUE = [1, 2, 3, 4]
IS_REAL = 5
NUM_STATIC_DATA_COLS = 6


class StaticDataChip(Chip):
    name = "static_data"

    def __init__(self):
        self.cells: dict[int, int] = {}

    def load(self, cells: dict[int, int]):
        self.cells = dict(cells)

    def write(self, address: int, value: int):
        self.cells[address] = value

    def width(self):
        return NUM_STATIC_DATA_COLS

    def generate_trace(self, machine):
        n = len(self.cells)
        n2 = 1 << max((n - 1).bit_length(), 0) if n else 1
        rows = np.zeros((n2, NUM_STATIC_DATA_COLS), dtype=np.uint32)
        for i, (addr, value) in enumerate(sorted(self.cells.items())):
            rows[i, ADDR] = addr % bb.P
            for k, byte in enumerate(u32_to_bytes(value)):
                rows[i, VALUE[k]] = byte
            rows[i, IS_REAL] = 1
        return rows

    def global_sends(self, machine):
        fields = [
            VPCol.const(0),  # is_read
            VPCol.const(0),  # clk
            VPCol.single_main(ADDR),
            VPCol.const(1),  # is_static_initial
        ] + [VPCol.single_main(VALUE[i]) for i in range(4)]
        return [
            Interaction(fields=fields, count=VPCol.single_main(IS_REAL),
                        bus=machine.mem_bus())
        ]

    def eval(self, b):
        local = b.main_local
        nxt = b.main_next
        b.when_transition().when(local[IS_REAL] * nxt[IS_REAL]).assert_eq(
            nxt[ADDR], local[ADDR] + 4
        )
