"""Machine base: an ordered collection of chips + prove/verify entry points.

Counterpart of valida_tpu/machine/machine.py (the Rust `Machine` trait);
a concrete machine lists its chips and the buses they use.
"""

from __future__ import annotations

from .verifier import verify as _verify


class Machine:

    # bus accessors; concrete machines override (the Rust
    # basic/src/lib.rs:1191-1211)


    def verify(self, config, proof):
        return _verify(self, config, proof)
