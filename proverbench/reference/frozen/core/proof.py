"""Proof objects (mirrors `machine/src/proof.rs:13-44`).

Counterpart of valida_tpu/core/proof.py.  All values are host canonical
ints, ext tuples and numpy u32 arrays, so proofs serialize and verify
without a device, and a proof of either package holds the same values
under the same field names.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Commitments:
    preprocessed: np.ndarray  # 8 x u32 root (8 zero words without one)
    main_trace: np.ndarray
    perm_trace: np.ndarray
    quotient_chunks: np.ndarray


@dataclasses.dataclass
class OpenedValues:
    preprocessed_local: list  # [ext tuple] per column ([] if no prep trace)
    preprocessed_next: list
    trace_local: list
    trace_next: list
    permutation_local: list
    permutation_next: list
    quotient_chunks: list


@dataclasses.dataclass
class ChipProof:
    log_degree: int
    opened_values: OpenedValues
    cumulative_sum: tuple  # ext


@dataclasses.dataclass
class MachineProof:
    commitments: Commitments
    opening_proof: object  # commit.pcs.PcsProof
    chip_proofs: list  # [ChipProof]
