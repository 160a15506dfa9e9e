"""Machine base: an ordered collection of chips + prove/verify entry points.

Counterpart of valida_tpu/machine/machine.py (the Rust `Machine` trait);
a concrete machine lists its chips and the buses they use.
"""

from __future__ import annotations

from .prover import prove as _prove
from .verifier import verify as _verify


class Machine:
    def chips(self) -> list:
        raise NotImplementedError

    # bus accessors; concrete machines override (the Rust
    # basic/src/lib.rs:1191-1211)
    def general_bus(self):
        raise NotImplementedError

    def program_bus(self):
        raise NotImplementedError

    def mem_bus(self):
        raise NotImplementedError

    def range_bus(self):
        raise NotImplementedError

    def byte_bus(self):
        """Byte-op delegation bus (chips/byte.py); None if the machine has
        no byte chip."""
        return None

    def prove(self, config):
        return _prove(self, config)

    def verify(self, config, proof):
        return _verify(self, config, proof)
