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

    def prove(self, config):
        return _prove(self, config)

    def verify(self, config, proof):
        return _verify(self, config, proof)
