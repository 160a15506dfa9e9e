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

import numpy as np
import torch

from ..air.types import SEND, RECEIVE
from ..convert import from_reference, u32_as_int64
from ..field import babybear as bb


class Chip:
    name = "chip"

    # -- trace -------------------------------------------------------------

    def width(self) -> int:
        raise NotImplementedError

    def preprocessed_width(self) -> int:
        p = self.preprocessed_trace()
        return 0 if p is None else int(p.shape[1])

    def generate_trace(self, machine) -> np.ndarray:
        """[N, width] canonical uint32, N a power of two, made on the host
        (chips without a builder)."""
        raise NotImplementedError

    def preprocessed_trace(self):
        return None

    # -- trace built where the proof runs -------------------------------

    def device_trace_inputs(self, machine):
        """(inputs: tuple of np.uint32 arrays, meta: python statics) for
        build_trace, or None if this chip has no builder."""
        return None

    def build_trace(self, inputs, meta) -> torch.Tensor:
        """The [n2, width] canonical trace as an int32 tensor on the
        inputs' device; inputs are the u32 arrays of device_trace_inputs as
        int32 bit patterns (convert.from_reference)."""
        raise NotImplementedError

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


def trace_on(chip, machine, device) -> torch.Tensor:
    """The chip's main trace as an int32 tensor on `device`: a chip with a
    builder uploads its op arrays and builds there; any other chip makes
    its trace on the host and uploads it once."""
    dti = chip.device_trace_inputs(machine)
    if dti is None:
        return from_reference(
            np.asarray(chip.generate_trace(machine), dtype=np.uint32), device)
    inputs, meta = dti
    return chip.build_trace(tuple(from_reference(x, device) for x in inputs),
                            meta)


def next_pow2(n: int) -> int:
    return 1 << max((n - 1).bit_length(), 0) if n else 1


# -- builder helpers: int64 columns holding u32 values -------------------------


def wide(inputs):
    """int32 bit patterns -> int64 values in [0, 2^32), one per input."""
    return tuple(u32_as_int64(x) for x in inputs)


def mod_p(x: torch.Tensor) -> torch.Tensor:
    """u32 value -> its residue mod p (int64)."""
    return x % bb.P


def assemble_columns(width: int, n2: int, cols: dict,
                     device) -> torch.Tensor:
    """{col index: vector of length n2} -> [n2, width] int32 trace; absent
    columns are zero."""
    out = torch.zeros((n2, width), dtype=torch.int32, device=device)
    for i, v in cols.items():
        out[:, i] = v
    return out


def grow(v: torch.Tensor, n2: int, pad: int = 0) -> torch.Tensor:
    """Extend a length-n vector to n2 rows with a constant pad value."""
    v = v.to(torch.int64)
    n = int(v.shape[0])
    if n == n2:
        return v
    return torch.cat([v, v.new_full((n2 - n,), pad)])


def be_byte(values: torch.Tensor, i: int) -> torch.Tensor:
    """i-th big-endian byte of u32 values (i=0 most significant)."""
    return (values >> (8 * (3 - i))) & 0xFF


def le_byte(values: torch.Tensor, i: int) -> torch.Tensor:
    """i-th little-endian byte (i=0 least significant)."""
    return (values >> (8 * i)) & 0xFF


def canon_inv(x: torch.Tensor) -> torch.Tensor:
    """x^-1 mod p (0 -> 0) of canonical values (int64, below p, so the
    field kernels take them as int32 words unchanged), through the batched
    inversion (inverses are unique, so the JAX package's words)."""
    return bb.from_monty(bb.inv_batch(bb.to_monty(x.to(torch.int32)))).to(
        torch.int64)


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
