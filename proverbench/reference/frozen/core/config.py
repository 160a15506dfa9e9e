"""Prover configuration (mirrors `machine/src/config.rs` and the Rust CLI's
concrete instantiation).

Counterpart of valida_tpu/core/config.py.  `device` is the PCS's device:
the prover keeps its traces there and runs the kernels on it ("cuda", the
default, raises when no GPU is present; "cpu" runs the plain versions).
"""

from __future__ import annotations

import dataclasses

from ..commit.fri import FriConfig
from ..commit.pcs import TwoAdicFriPcs
from ..crypto.challenger import DuplexChallenger
from ..field import babybear as bb


@dataclasses.dataclass
class StarkConfig:
    pcs: TwoAdicFriPcs
    debug_checks: bool = True  # row-wise constraint + bus-balance checking

    def challenger(self) -> DuplexChallenger:
        return DuplexChallenger()


def default_config(num_queries: int = 40, proof_of_work_bits: int = 8,
                   log_blowup: int = 1, debug_checks: bool = True,
                   hasher: str = "keccak", log_final: int = 0,
                   device="cuda") -> StarkConfig:
    """The Rust CLI's parameters: blowup 2, 40 queries, 8-bit PoW.

    hasher selects the Merkle hash: "keccak" (the default) or "poseidon2".
    log_final > 0 stops FRI folding early and ships a 2^log_final-
    coefficient final polynomial."""
    fri = FriConfig(
        log_blowup=log_blowup,
        num_queries=num_queries,
        proof_of_work_bits=proof_of_work_bits,
        hasher=hasher,
        log_final=log_final,
    )
    return StarkConfig(pcs=TwoAdicFriPcs(fri, coset_shift=bb.GENERATOR,
                                         device=device),
                       debug_checks=debug_checks)


def test_config(debug_checks: bool = True, device="cuda") -> StarkConfig:
    """Reduced-security config for fast tests."""
    return default_config(num_queries=4, proof_of_work_bits=2,
                          debug_checks=debug_checks, device=device)


test_config.__test__ = False  # not a pytest test when star-imported
