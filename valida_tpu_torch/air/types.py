"""Interaction / virtual-column types for the bus (LogUp) argument.

Counterpart of valida_tpu/air/types.py: `Interaction`, `InteractionType`,
`BusArgument` and p3-air's `VirtualPairCol` as the Rust machine crate uses
them.
"""

from __future__ import annotations

import dataclasses

from ..field import babybear as bb

LOCAL = "local"
GLOBAL = "global"

SEND = "send"
RECEIVE = "receive"


@dataclasses.dataclass(frozen=True)
class Bus:
    kind: str  # LOCAL | GLOBAL
    index: int

    @property
    def is_local(self):
        return self.kind == LOCAL


@dataclasses.dataclass
class VPCol:
    """Linear virtual column: sum_i w_i * col_i + constant.

    Column refs are ("main"|"prep", index); weights/constant canonical ints.
    """

    weights: list  # [(("main"|"prep", idx), weight)]
    constant: int = 0

    @staticmethod
    def single_main(i: int) -> "VPCol":
        return VPCol([(("main", i), 1)])

    @staticmethod
    def single_prep(i: int) -> "VPCol":
        return VPCol([(("prep", i), 1)])

    @staticmethod
    def const(c: int) -> "VPCol":
        return VPCol([], c % bb.P)

    @staticmethod
    def one() -> "VPCol":
        return VPCol([], 1)

    @staticmethod
    def sum_main(idxs) -> "VPCol":
        return VPCol([(("main", i), 1) for i in idxs])

    def apply(self, prep_vals, main_vals, const_fn):
        """Evaluate with wrapped expressions / arrays.

        prep_vals / main_vals: indexable value sequences; const_fn(int) wraps
        a canonical constant into the value domain.
        """
        acc = const_fn(self.constant)
        for (trace, idx), w in self.weights:
            col = main_vals[idx] if trace == "main" else prep_vals[idx]
            if w == 1:
                acc = acc + col
            else:
                acc = acc + const_fn(w) * col
        return acc


@dataclasses.dataclass
class Interaction:
    fields: list  # [VPCol]
    count: VPCol
    bus: Bus
