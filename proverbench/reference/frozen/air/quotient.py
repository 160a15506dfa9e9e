"""The quotient degree of a chip (the port's air/quotient.py, of which the
verifier needs this function alone)."""

from __future__ import annotations

from .builder import SymbolicBuilder


def get_log_quotient_degree(machine, chip) -> int:
    """ceil(log2(max(deg, 3) - 1)) — `symbolic_builder.rs:17-30`."""
    b = SymbolicBuilder(machine, chip)
    chip.eval(b)
    deg = max(b.max_degree, 3)
    return max((deg - 2).bit_length(), 0) if deg > 1 else 0
