"""Chip base class: trace generation + interactions + constraints.

Counterpart of valida_tpu/chips/chip.py (the Rust `Chip` trait, data
oriented): a chip produces a canonical u32 trace and writes its
constraints once against the generic builder (air/builder.py).

A chip whose trace follows from an op log exposes it as compact inputs
(`device_trace_inputs`: u32 numpy arrays made on the host, several times
smaller than the trace) and a builder (`build_trace`: torch operations on
those arrays, uploaded to the prover's device).  The prover uploads only
the op arrays and builds the [n2, width] trace where the proof runs
(`trace_on`); on a CPU device the same builder gives the host trace.  The
builders compute in int64 (torch has no u32
arithmetic): a u32 value v is held as v in [0, 2^32), and where the JAX
package relies on a u32 wrap the result is masked with 0xFFFFFFFF.
"""

from __future__ import annotations


from ..air.types import SEND, RECEIVE


class Chip:
    name = "chip"

    # -- trace -------------------------------------------------------------


    def preprocessed_width(self) -> int:
        p = self.preprocessed_trace()
        return 0 if p is None else int(p.shape[1])


    def preprocessed_trace(self):
        return None

    # -- trace built where the proof runs -------------------------------


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


# -- builder helpers: int64 columns holding u32 values -------------------------


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
