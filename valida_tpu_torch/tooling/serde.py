"""Proof serialization: CBOR interchange format.

Counterpart of valida_tpu/tooling/serde.py, with its own copy of the codec:
the Rust CLI's ciborium round-trip of `MachineProof`.  A minimal CBOR codec
(RFC 8949 subset: uints, negints, byte/text strings, arrays, maps) plus
structural encoders for MachineProof.  The encoder writes uint32 arrays
through the native host library (native/cbor.cpp) and everything else in
Python.  A proof of this package serializes to the same bytes as the JAX
package's proof of the same machine, and either package reads the other's
bytes.
"""

from __future__ import annotations

import functools
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


# Counts of the encoder: `cbor_dumps` calls, and the integers it wrote one
# at a time as Python ints (uint32 arrays go to the native writer whole).
stats = {"serializations": 0, "int_words": 0}

_U32 = np.dtype(np.uint32)
_MAX_WORD = 0xFFFFFFFF


@functools.lru_cache(maxsize=1024)
def _text(s: str) -> bytes:
    """A text string's head and bytes (a proof repeats a few dict keys
    thousands of times)."""
    b = s.encode()
    head = bytearray()
    _enc_head(3, len(b), head)
    return bytes(head) + b


def _skeleton(obj):
    """One walk of `obj`: (skeleton, marks, leaves, int words).  The
    skeleton holds every head, key and scalar in order; each uint32 array
    of one or more dimensions is a leaf, left out of the skeleton and
    marked at its offset there.  Every other array is written as its
    `tolist()`."""
    out = bytearray()
    leaves, marks = [], []
    put, mark = leaves.append, marks.append
    ints = 0

    def walk(o):
        nonlocal ints
        t = type(o)
        if t is dict:
            _enc_head(5, len(o), out)
            for k, v in o.items():
                if type(k) is str:
                    out.extend(_text(k))
                else:
                    walk(k)
                if type(v) is np.ndarray and v.dtype == _U32 and v.ndim:
                    mark(len(out))
                    put(v)
                else:
                    walk(v)
        elif t is list or t is tuple:
            _enc_head(4, len(o), out)
            for v in o:
                if type(v) is np.ndarray and v.dtype == _U32 and v.ndim:
                    mark(len(out))
                    put(v)
                else:
                    walk(v)
        elif isinstance(o, str):
            out.extend(_text(o))
        elif isinstance(o, bool):
            out.append(0xF5 if o else 0xF4)
        elif isinstance(o, (int, np.integer)):
            o = int(o)
            ints += 1
            if o >= 0:
                _enc_head(0, o, out)
            else:
                _enc_head(1, -1 - o, out)
        elif isinstance(o, bytes):
            _enc_head(2, len(o), out)
            out.extend(o)
        elif isinstance(o, (list, tuple)):
            walk(list(o))
        elif isinstance(o, np.ndarray):
            if o.dtype == _U32 and o.ndim:
                mark(len(out))
                put(o)
            else:
                walk(o.tolist())
        elif isinstance(o, dict):
            walk(dict(o))
        elif o is None:
            out.append(0xF6)
        else:
            raise TypeError(f"cannot CBOR-encode {type(o)}")

    walk(obj)
    return out, marks, leaves, ints


def cbor_dumps(obj) -> bytes:
    """The CBOR bytes of `obj`: one walk in Python writes the heads, keys
    and scalars, then one call of the native writer (native/cbor.cpp)
    writes them with every uint32 array's words in their places."""
    from .. import native

    with span("serialize: cbor"):
        out, marks, leaves, ints = _skeleton(obj)
        stats["serializations"] += 1
        stats["int_words"] += ints
        return native.cbor_write(out, marks, leaves)


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


def _words(x) -> np.ndarray:
    """`x` (an array, a list of digests, a list of ext tuples) as one array
    of its words: uint32 where every word fits, which the codec writes
    natively; otherwise as numpy reads it, which the codec writes int by
    int (an empty list too: no word)."""
    a = np.asarray(x)
    if (a.dtype != _U32 and a.dtype.kind in "iu" and a.size
            and a.min() >= 0 and a.max() <= _MAX_WORD):
        a = a.astype(np.uint32)
    return a


def _final_poly_from_obj(o):
    if o and isinstance(o[0], list):
        return tuple(tuple(int(x) for x in c) for c in o)
    return tuple(int(x) for x in o)


# the opened values of a chip, in the order of the proof's bytes
_OPENED = ("preprocessed_local", "preprocessed_next", "trace_local",
           "trace_next", "permutation_local", "permutation_next",
           "quotient_chunks")


def proof_to_obj(proof: MachineProof, config=None) -> dict:
    """The proof as the plain object that `cbor_dumps` writes: dicts and
    lists as the bytes nest them, every run of words one numpy array (an
    opened row, a digest, a pair row, a Merkle path [depth, 8], a list of
    opened ext values [n, 5]), and Python ints for the rest."""
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
            "preprocessed": _words(proof.commitments.preprocessed),
            "main_trace": _words(proof.commitments.main_trace),
            "perm_trace": _words(proof.commitments.perm_trace),
            "quotient_chunks": _words(proof.commitments.quotient_chunks),
        },
        "fri": {
            "commits": [_words(c) for c in fri.commit_phase_commits],
            "final_poly": _words(fri.final_poly),
            "pow_witness": int(fri.pow_witness),
            "query_proofs": [
                [
                    {
                        "pair_row": _words(o.pair_row),
                        "path": _words(o.path),
                    }
                    for o in q.commit_phase_openings
                ]
                for q in fri.query_proofs
            ],
        },
        "pcs_queries": [
            [
                {
                    "rows": list(bo.opened_rows),
                    "path": _words(bo.path),
                }
                for bo in qp.input_openings
            ]
            for qp in proof.opening_proof.query_proofs
        ],
        "chip_proofs": [
            {
                "log_degree": cp.log_degree,
                "cumulative_sum": _words(cp.cumulative_sum),
                "opened": {
                    name: _words(getattr(cp.opened_values, name))
                    for name in _OPENED
                },
            }
            for cp in proof.chip_proofs
        ],
    }
    # only present when log_final > 0 produced direct-opened tiny matrices
    # (keeps the log_final == 0 byte format unchanged)
    if getattr(proof.opening_proof, "direct_polys", None):
        obj["direct_polys"] = [
            _words(m) for m in proof.opening_proof.direct_polys]
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
