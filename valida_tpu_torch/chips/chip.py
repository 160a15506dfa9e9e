"""Chip base class: trace generation + interactions + constraints.

Counterpart of valida_tpu/chips/chip.py (the Rust `Chip` trait, data
oriented): a chip produces a canonical u32 numpy trace on the host and
writes its constraints once against the generic builder (air/builder.py).
"""

from __future__ import annotations

import numpy as np

from ..air.types import SEND, RECEIVE


class Chip:
    name = "chip"

    # -- trace -------------------------------------------------------------

    def width(self) -> int:
        raise NotImplementedError

    def preprocessed_width(self) -> int:
        p = self.preprocessed_trace()
        return 0 if p is None else int(p.shape[1])

    def generate_trace(self, machine) -> np.ndarray:
        """[N, width] canonical uint32, N a power of two."""
        raise NotImplementedError

    def preprocessed_trace(self):
        return None

    # -- interactions ------------------------------------------------------

    def local_sends(self) -> list:
        return []

    def local_receives(self) -> list:
        return []

    def global_sends(self, machine) -> list:
        return []

    def global_receives(self, machine) -> list:
        return []

    def typed_interactions(self, machine):
        out = []
        out += [(i, SEND) for i in self.local_sends()]
        out += [(i, RECEIVE) for i in self.local_receives()]
        out += [(i, SEND) for i in self.global_sends(machine)]
        out += [(i, RECEIVE) for i in self.global_receives(machine)]
        return out

    def all_interactions(self, machine):
        return [i for i, _t in self.typed_interactions(machine)]

    # -- constraints -------------------------------------------------------

    def eval(self, builder):
        pass


def pad_to_power_of_two(rows: np.ndarray) -> np.ndarray:
    """Pad a [N, W] trace with zero rows to the next power of two
    (`util/src/lib.rs:45-49`)."""
    n = rows.shape[0]
    if n == 0:
        n2 = 1
    else:
        n2 = 1 << max((n - 1).bit_length(), 0)
    if n2 == n:
        return rows
    pad = np.zeros((n2 - n, rows.shape[1]), dtype=rows.dtype)
    return np.concatenate([rows, pad], axis=0)


class IndexAllocator:
    """Tiny column-layout helper: named scalar/word/array column indices."""

    def __init__(self):
        self.width = 0

    def scalar(self) -> int:
        i = self.width
        self.width += 1
        return i

    def word(self) -> list:
        return self.array(4)

    def array(self, n: int) -> list:
        out = list(range(self.width, self.width + n))
        self.width += n
        return out
