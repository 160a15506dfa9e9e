"""Static data chip
(counterpart of valida_tpu/chips/static_data.py; mirrors the Rust
`static_data/src/{lib,columns,stark}.rs`):
preloads ELF data sections into memory and balances the memory chip's
initial-write rows on the memory bus."""

from __future__ import annotations


from ..air.types import VPCol, Interaction
from .chip import Chip

ADDR = 0
VALUE = [1, 2, 3, 4]
IS_REAL = 5
NUM_STATIC_DATA_COLS = 6


class StaticDataChip(Chip):
    name = "static_data"

    def __init__(self):
        self.cells: dict[int, int] = {}


    def width(self):
        return NUM_STATIC_DATA_COLS


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
