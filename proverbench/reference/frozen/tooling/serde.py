"""Proof serialization: CBOR interchange format.

Counterpart of valida_tpu/tooling/serde.py, with its own copy of the codec:
the Rust CLI's ciborium round-trip of `MachineProof`.  A minimal
self-contained CBOR codec (RFC 8949 subset: uints, negints, byte/text
strings, arrays, maps) plus structural encoders for MachineProof.  A proof
of this package serializes to the same bytes as the JAX package's proof of
the same machine, and either package reads the other's bytes.
"""

from __future__ import annotations

import struct

import numpy as np

from ..core.proof import MachineProof, Commitments, ChipProof, OpenedValues
from ..commit.pcs import PcsProof, PcsQueryProof, BatchOpening
from ..commit.fri import FriProof, FriQueryProof, CommitPhaseOpening

# ---------------------------------------------------------------------------
# CBOR codec
# ---------------------------------------------------------------------------


class _Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("truncated CBOR")
        self.pos += n
        return b

    def _head(self):
        b = self._take(1)[0]
        major, info = b >> 5, b & 0x1F
        if info < 24:
            return major, info
        if info == 24:
            return major, self._take(1)[0]
        if info == 25:
            return major, struct.unpack(">H", self._take(2))[0]
        if info == 26:
            return major, struct.unpack(">I", self._take(4))[0]
        if info == 27:
            return major, struct.unpack(">Q", self._take(8))[0]
        raise ValueError("indefinite lengths unsupported")

    def decode(self):
        b0 = self.data[self.pos]
        if b0 == 0xF4:
            self.pos += 1
            return False
        if b0 == 0xF5:
            self.pos += 1
            return True
        if b0 == 0xF6:
            self.pos += 1
            return None
        major, value = self._head()
        if major == 0:
            return value
        if major == 1:
            return -1 - value
        if major == 2:
            return self._take(value)
        if major == 3:
            return self._take(value).decode()
        if major == 4:
            return [self.decode() for _ in range(value)]
        if major == 5:
            return {self.decode(): self.decode() for _ in range(value)}
        raise ValueError(f"unsupported CBOR major type {major}")


def cbor_loads(data: bytes):
    d = _Decoder(data)
    obj = d.decode()
    if d.pos != len(data):
        raise ValueError("trailing CBOR bytes")
    return obj


# ---------------------------------------------------------------------------
# Proof <-> plain-object structure
# ---------------------------------------------------------------------------


def _final_poly_from_obj(o):
    if o and isinstance(o[0], list):
        return tuple(tuple(int(x) for x in c) for c in o)
    return tuple(int(x) for x in o)


def _digest_arr(o):
    return np.array(o, dtype=np.uint32)


def proof_from_obj(obj: dict) -> MachineProof:
    fri_obj = obj["fri"]
    fri_queries = [
        FriQueryProof(
            commit_phase_openings=[
                CommitPhaseOpening(
                    pair_row=np.array(o["pair_row"], dtype=np.uint32),
                    path=[_digest_arr(p) for p in o["path"]],
                )
                for o in q
            ]
        )
        for q in fri_obj["query_proofs"]
    ]
    fri = FriProof(
        commit_phase_commits=[_digest_arr(c) for c in fri_obj["commits"]],
        final_poly=_final_poly_from_obj(fri_obj["final_poly"]),
        pow_witness=fri_obj["pow_witness"],
        query_proofs=fri_queries,
    )
    pcs_queries = [
        PcsQueryProof(
            input_openings=[
                BatchOpening(
                    opened_rows=[np.array(r, dtype=np.uint32) for r in bo["rows"]],
                    path=[_digest_arr(p) for p in bo["path"]],
                )
                for bo in qp
            ],
            fri_query=fri_queries[qi],
        )
        for qi, qp in enumerate(obj["pcs_queries"])
    ]
    chip_proofs = [
        ChipProof(
            log_degree=cp["log_degree"],
            cumulative_sum=tuple(cp["cumulative_sum"]),
            opened_values=OpenedValues(
                preprocessed_local=[tuple(v) for v in cp["opened"]["preprocessed_local"]],
                preprocessed_next=[tuple(v) for v in cp["opened"]["preprocessed_next"]],
                trace_local=[tuple(v) for v in cp["opened"]["trace_local"]],
                trace_next=[tuple(v) for v in cp["opened"]["trace_next"]],
                permutation_local=[tuple(v) for v in cp["opened"]["permutation_local"]],
                permutation_next=[tuple(v) for v in cp["opened"]["permutation_next"]],
                quotient_chunks=[tuple(v) for v in cp["opened"]["quotient_chunks"]],
            ),
        )
        for cp in obj["chip_proofs"]
    ]
    c = obj["commitments"]
    return MachineProof(
        commitments=Commitments(
            preprocessed=_digest_arr(c["preprocessed"]),
            main_trace=_digest_arr(c["main_trace"]),
            perm_trace=_digest_arr(c["perm_trace"]),
            quotient_chunks=_digest_arr(c["quotient_chunks"]),
        ),
        opening_proof=PcsProof(
            fri=fri,
            query_proofs=pcs_queries,
            direct_polys=[
                np.array(m, dtype=np.uint32)
                for m in obj.get("direct_polys", [])
            ],
        ),
        chip_proofs=chip_proofs,
    )


def deserialize_proof(data: bytes) -> MachineProof:
    return proof_from_obj(cbor_loads(data))
