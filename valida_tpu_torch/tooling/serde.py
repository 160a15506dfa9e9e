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
from ..utils import span

# ---------------------------------------------------------------------------
# CBOR codec
# ---------------------------------------------------------------------------


def _enc_head(major: int, value: int, out: bytearray):
    if value < 24:
        out.append((major << 5) | value)
    elif value < 0x100:
        out.append((major << 5) | 24)
        out.append(value)
    elif value < 0x10000:
        out.append((major << 5) | 25)
        out += struct.pack(">H", value)
    elif value < 0x100000000:
        out.append((major << 5) | 26)
        out += struct.pack(">I", value)
    else:
        out.append((major << 5) | 27)
        out += struct.pack(">Q", value)


def _encode(obj, out: bytearray):
    if isinstance(obj, bool):
        out.append(0xF5 if obj else 0xF4)
    elif isinstance(obj, (int, np.integer)):
        obj = int(obj)
        if obj >= 0:
            _enc_head(0, obj, out)
        else:
            _enc_head(1, -1 - obj, out)
    elif isinstance(obj, bytes):
        _enc_head(2, len(obj), out)
        out += obj
    elif isinstance(obj, str):
        b = obj.encode()
        _enc_head(3, len(b), out)
        out += b
    elif isinstance(obj, (list, tuple)):
        _enc_head(4, len(obj), out)
        for item in obj:
            _encode(item, out)
    elif isinstance(obj, np.ndarray):
        _encode(obj.tolist(), out)
    elif isinstance(obj, dict):
        _enc_head(5, len(obj), out)
        for k, v in obj.items():
            _encode(k, out)
            _encode(v, out)
    elif obj is None:
        out.append(0xF6)
    else:
        raise TypeError(f"cannot CBOR-encode {type(obj)}")


def cbor_dumps(obj) -> bytes:
    with span("serialize: cbor"):
        out = bytearray()
        _encode(obj, out)
        return bytes(out)


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


def _digest_obj(d):
    return [int(x) for x in np.asarray(d)]


def _ext_obj(e):
    return [int(x) for x in e]


def _final_poly_obj(fp):
    """final_poly is one ext scalar (log_final == 0) or a coefficient list
    of ext scalars (log_final > 0) — preserve the shape byte-for-byte."""
    if fp and isinstance(fp[0], (tuple, list)):
        return [_ext_obj(c) for c in fp]
    return _ext_obj(fp)


def _final_poly_from_obj(o):
    if o and isinstance(o[0], list):
        return tuple(tuple(int(x) for x in c) for c in o)
    return tuple(int(x) for x in o)


def proof_to_obj(proof: MachineProof, config=None) -> dict:
    with span("serialize: to object"):
        return _proof_obj(proof, config)


def _proof_obj(proof: MachineProof, config) -> dict:
    from ..crypto import poseidon

    fri = proof.opening_proof.fri
    # Transcript-configuration header: a proof produced under a different
    # Fiat-Shamir configuration fails verification with no diagnostics; the
    # meta block lets the verifier name the mismatch instead.  Older proofs
    # lack it (deserialize tolerates that).
    meta = {"v": 1, "poseidon": poseidon.PARAM_SET}
    if config is not None:
        meta["hasher"] = config.pcs.config.hasher
    obj = {
        "meta": meta,
        "commitments": {
            "preprocessed": _digest_obj(proof.commitments.preprocessed),
            "main_trace": _digest_obj(proof.commitments.main_trace),
            "perm_trace": _digest_obj(proof.commitments.perm_trace),
            "quotient_chunks": _digest_obj(proof.commitments.quotient_chunks),
        },
        "fri": {
            "commits": [_digest_obj(c) for c in fri.commit_phase_commits],
            "final_poly": _final_poly_obj(fri.final_poly),
            "pow_witness": int(fri.pow_witness),
            "query_proofs": [
                [
                    {
                        "pair_row": [int(x) for x in o.pair_row],
                        "path": [_digest_obj(p) for p in o.path],
                    }
                    for o in q.commit_phase_openings
                ]
                for q in fri.query_proofs
            ],
        },
        "pcs_queries": [
            [
                {
                    "rows": [[int(x) for x in r] for r in bo.opened_rows],
                    "path": [_digest_obj(p) for p in bo.path],
                }
                for bo in qp.input_openings
            ]
            for qp in proof.opening_proof.query_proofs
        ],
        "chip_proofs": [
            {
                "log_degree": cp.log_degree,
                "cumulative_sum": _ext_obj(cp.cumulative_sum),
                "opened": {
                    "preprocessed_local": [_ext_obj(v) for v in cp.opened_values.preprocessed_local],
                    "preprocessed_next": [_ext_obj(v) for v in cp.opened_values.preprocessed_next],
                    "trace_local": [_ext_obj(v) for v in cp.opened_values.trace_local],
                    "trace_next": [_ext_obj(v) for v in cp.opened_values.trace_next],
                    "permutation_local": [_ext_obj(v) for v in cp.opened_values.permutation_local],
                    "permutation_next": [_ext_obj(v) for v in cp.opened_values.permutation_next],
                    "quotient_chunks": [_ext_obj(v) for v in cp.opened_values.quotient_chunks],
                },
            }
            for cp in proof.chip_proofs
        ],
    }
    # only present when log_final > 0 produced direct-opened tiny matrices
    # (keeps the log_final == 0 byte format unchanged)
    if getattr(proof.opening_proof, "direct_polys", None):
        obj["direct_polys"] = [
            [[int(x) for x in row] for row in np.asarray(m)]
            for m in proof.opening_proof.direct_polys
        ]
    return obj


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


def proof_meta(data: bytes) -> dict:
    """Transcript-configuration header of a serialized proof ({} for
    older proofs that predate the meta block)."""
    obj = cbor_loads(data)
    return obj.get("meta", {}) if isinstance(obj, dict) else {}


def serialize_proof(proof: MachineProof, config=None) -> bytes:
    return cbor_dumps(proof_to_obj(proof, config))


def deserialize_proof(data: bytes) -> MachineProof:
    return proof_from_obj(cbor_loads(data))
