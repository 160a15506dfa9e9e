"""Proof serialization through the native CBOR writer
(valida_tpu_torch/native/cbor.cpp, `native.cbor_write`, behind
`serde.cbor_dumps`) held byte for byte to the plain encoder: the int-by-int
`_proof_obj` and `_encode` kept below, and the JAX package's codec.

The proofs are synthetic, shaped like the benchmark's configurations at
their frozen sizes (`proverbench/configs/*.json`: each chip's widths and
heights, 40 or 100 queries, trees 12-24 levels deep), with random words and
the head-width boundaries 0, 23, 24, 255, 256, 65535, 65536, 2^31 - 1,
p - 1 and 2^32 - 1 at every kind of position."""

from __future__ import annotations

import importlib.util
import json
import struct
from pathlib import Path

import numpy as np
import pytest

from valida_tpu.tooling import serde as jax_serde
from valida_tpu_torch import native
from valida_tpu_torch.commit.fri import (CommitPhaseOpening, FriProof,
                                         FriQueryProof)
from valida_tpu_torch.commit.pcs import (BatchOpening, PcsProof,
                                         PcsQueryProof)
from valida_tpu_torch.core.config import default_config
from valida_tpu_torch.core.proof import (ChipProof, Commitments, MachineProof,
                                         OpenedValues)
from valida_tpu_torch.native import build as native_build
from valida_tpu_torch.tooling import serde

P = 2013265921
BOUNDARY = [0, 23, 24, 255, 256, 65535, 65536, 2**31 - 1, P - 1, 2**32 - 1]
CONFIGS = Path(__file__).resolve().parents[1] / "proverbench" / "configs"
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "mini_proof_v1.cbor"
EXT = 5
DIGEST = 8
PAIR_WORDS = 10

# ---------------------------------------------------------------------------
# the plain encoder: proof_to_obj and the codec before the native writer
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


def plain_dumps(obj) -> bytes:
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


def _digest_obj(d):
    return [int(x) for x in np.asarray(d)]


def _ext_obj(e):
    return [int(x) for x in e]


def _final_poly_obj(fp):
    if fp and isinstance(fp[0], (tuple, list)):
        return [_ext_obj(c) for c in fp]
    return _ext_obj(fp)


def plain_proof_obj(proof: MachineProof, config=None) -> dict:
    from valida_tpu_torch.crypto import poseidon

    fri = proof.opening_proof.fri
    meta = {"v": 1, "poseidon": poseidon.PARAM_SET}
    if config is not None:
        meta["hasher"] = config.pcs.config.hasher
    ov = lambda cp, name: [_ext_obj(v)  # noqa: E731
                           for v in getattr(cp.opened_values, name)]
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
                [{"pair_row": [int(x) for x in o.pair_row],
                  "path": [_digest_obj(p) for p in o.path]}
                 for o in q.commit_phase_openings]
                for q in fri.query_proofs],
        },
        "pcs_queries": [
            [{"rows": [[int(x) for x in r] for r in bo.opened_rows],
              "path": [_digest_obj(p) for p in bo.path]}
             for bo in qp.input_openings]
            for qp in proof.opening_proof.query_proofs],
        "chip_proofs": [
            {"log_degree": cp.log_degree,
             "cumulative_sum": _ext_obj(cp.cumulative_sum),
             "opened": {name: ov(cp, name) for name in (
                 "preprocessed_local", "preprocessed_next", "trace_local",
                 "trace_next", "permutation_local", "permutation_next",
                 "quotient_chunks")}}
            for cp in proof.chip_proofs],
    }
    if getattr(proof.opening_proof, "direct_polys", None):
        obj["direct_polys"] = [
            [[int(x) for x in row] for row in np.asarray(m)]
            for m in proof.opening_proof.direct_polys]
    return obj


def plain_serialize(proof, config=None) -> bytes:
    return plain_dumps(plain_proof_obj(proof, config))


# ---------------------------------------------------------------------------
# synthetic proofs of the configurations' shapes
# ---------------------------------------------------------------------------


def words(rng, shape) -> np.ndarray:
    """uint32 words of every head width, a tenth of them boundary values,
    the first of each run a boundary value in turn."""
    n = int(np.prod(shape))
    cls = rng.integers(0, 5, n)
    w = rng.integers(0, 2**32, n, dtype=np.uint64)
    w = np.where(cls == 1, w % 24, w)
    w = np.where(cls == 2, w % 256, w)
    w = np.where(cls == 3, w % 65536, w)
    pick = rng.random(n) < 0.1
    w[pick] = rng.choice(BOUNDARY, int(pick.sum()))
    if n:
        w[0] = BOUNDARY[int(rng.integers(len(BOUNDARY)))]
    return w.astype(np.uint32).reshape(shape)


def exts(rng, n: int) -> list:
    return [tuple(row) for row in words(rng, (n, EXT)).tolist()]


def size_of(name: str, log_size: int) -> tuple[dict, dict]:
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    return cfg["sizes"][str(log_size)], cfg["profile"]


def synthetic_proof(name: str, log_size: int, seed: int,
                    direct: bool = False) -> MachineProof:
    """A MachineProof of the configuration's shape at the size: the four
    commitment rounds (prep, main, perm, quotient chunks) opened at every
    query, one row a matrix, each round's rows and paths ([depth, 8])
    views of one fetched [queries, ...] array, as the staged prover
    assembles them; the FRI layers from the tallest LDE down to
    2^(log_blowup + 1) rows."""
    size, profile = size_of(name, log_size)
    rng = np.random.default_rng(seed)
    lb, nq = int(profile["log_blowup"]), int(profile["num_queries"])
    chips = list(size["chips"].values())
    rounds = [[(c["log_height"], c["prep_width"]) for c in chips
               if c["prep_width"]],
              [(c["log_height"], c["main_width"]) for c in chips],
              [(c["log_height"], c["perm_width"]) for c in chips],
              [(c["log_height"], EXT << c["log_qd"]) for c in chips]]
    rounds = [r for r in rounds if r]
    log_max = max(lh for r in rounds for lh, _w in r) + lb
    round_opens = []
    for r in rounds:
        depth = max(lh for lh, _w in r) + lb
        rows = [words(rng, (nq, w)) for _lh, w in r]
        round_opens.append((rows, words(rng, (nq, depth, DIGEST))))
    layers = list(range(log_max, lb, -1))
    layer_opens = [(words(rng, (nq, PAIR_WORDS)),
                    words(rng, (nq, log_m - 1, DIGEST))) for log_m in layers]
    fri_queries = [
        FriQueryProof(commit_phase_openings=[
            CommitPhaseOpening(pair_row=rows[qi], path=paths[qi])
            for rows, paths in layer_opens])
        for qi in range(nq)]
    fri = FriProof(commit_phase_commits=list(words(rng, (len(layers), DIGEST))),
                   final_poly=exts(rng, 1)[0],
                   pow_witness=int(rng.integers(0, P)),
                   query_proofs=fri_queries)
    queries = [
        PcsQueryProof(input_openings=[
            BatchOpening(opened_rows=[r[qi] for r in rows],
                         path=paths[qi])
            for rows, paths in round_opens], fri_query=fri_queries[qi])
        for qi in range(nq)]
    direct_polys = ([words(rng, (4, 3)), words(rng, (2, 10))] if direct
                    else [])
    chip_proofs = [
        ChipProof(
            log_degree=c["log_height"],
            opened_values=OpenedValues(
                preprocessed_local=exts(rng, c["prep_width"]),
                preprocessed_next=exts(rng, c["prep_width"]),
                trace_local=exts(rng, c["main_width"]),
                trace_next=exts(rng, c["main_width"]),
                permutation_local=exts(rng, c["perm_width"] // EXT),
                permutation_next=exts(rng, c["perm_width"] // EXT),
                quotient_chunks=exts(rng, EXT << c["log_qd"])),
            cumulative_sum=exts(rng, 1)[0])
        for c in chips]
    roots = words(rng, (4, DIGEST))
    return MachineProof(
        commitments=Commitments(*roots),
        opening_proof=PcsProof(fri=fri, query_proofs=queries,
                               direct_polys=direct_polys),
        chip_proofs=chip_proofs)


def proof_words(proof: MachineProof) -> int:
    """The words of a proof: what the plain encoder writes as ints."""
    count = 0

    def walk(o):
        nonlocal count
        if isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, list):
            for v in o:
                walk(v)
        elif isinstance(o, int):
            count += 1

    walk(plain_proof_obj(proof))
    return count


CELLS = [("fibonacci", 10), ("fibonacci", 20), ("sha2_chain", 21),
         ("fibonacci_poseidon2", 21)]
CELL_IDS = [f"{n}.{s}" for n, s in CELLS]


@pytest.fixture(scope="module")
def cell_proofs():
    return {cell: synthetic_proof(*cell, seed=7) for cell in CELLS}


# ---------------------------------------------------------------------------
# byte identity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS, ids=CELL_IDS)
def test_proof_bytes_equal_the_plain_encoder_and_the_jax_codec(cell_proofs,
                                                               cell):
    """serialize_proof of a proof shaped like the cell's equals the plain
    encoder's bytes and the JAX package's codec of the plain object, with
    and without a config's hasher in the meta block."""
    proof = cell_proofs[cell]
    config = default_config(device="cpu")
    for cfg in (None, config):
        want = plain_serialize(proof, cfg)
        assert jax_serde.cbor_dumps(plain_proof_obj(proof, cfg)) == want
        assert serde.serialize_proof(proof, cfg) == want
        assert serde.cbor_dumps(serde.proof_to_obj(proof, cfg)) == want


def test_synthetic_proofs_have_the_configurations_sizes(cell_proofs):
    """The synthetic proofs hold as many words as the cells' proofs: 86 k
    (short10), 164 k (seg20), 173 k (sha2_chain seg21) and 433 k
    (fibonacci_poseidon2 seg21), within 8%."""
    want = {("fibonacci", 10): 86e3, ("fibonacci", 20): 164e3,
            ("sha2_chain", 21): 173e3, ("fibonacci_poseidon2", 21): 433e3}
    for cell, n in want.items():
        assert proof_words(cell_proofs[cell]) == pytest.approx(n, rel=0.08)


@pytest.mark.parametrize("cell", CELLS, ids=CELL_IDS)
def test_deserialized_proof_bytes(cell_proofs, cell):
    """A proof read back by deserialize_proof (arrays from lists, opened
    values as tuples) serializes to the same bytes again, and so does the
    proof with one opened value altered, as the benchmark's control alters
    it."""
    want = plain_serialize(cell_proofs[cell])
    proof = serde.deserialize_proof(want)
    assert serde.serialize_proof(proof) == want
    ov = proof.chip_proofs[0].opened_values
    v = tuple(ov.trace_local[0])
    ov.trace_local[0] = ((v[0] + 1) % P,) + v[1:]
    assert serde.serialize_proof(proof) == plain_serialize(proof)


@pytest.mark.parametrize("seed", [1, 2])
def test_direct_polys_bytes(seed):
    """A proof with direct-opened matrices (log_final > 0) and a final
    polynomial of several coefficients writes the plain encoder's bytes."""
    proof = synthetic_proof("fibonacci", 10, seed, direct=True)
    rng = np.random.default_rng(seed)
    proof.opening_proof.fri.final_poly = tuple(exts(rng, 4))
    want = plain_serialize(proof)
    assert b"direct_polys" in want
    assert jax_serde.cbor_dumps(plain_proof_obj(proof)) == want
    assert serde.serialize_proof(proof) == want
    assert serde.serialize_proof(serde.deserialize_proof(want)) == want


@pytest.mark.parametrize("cell", CELLS + [("sha2_chain", 13)],
                         ids=CELL_IDS + ["sha2_chain.13"])
@pytest.mark.parametrize("seed", [11, 12])
def test_round_trip(cell, seed):
    """deserialize_proof(serialize_proof(p)) serializes to the same bytes."""
    proof = synthetic_proof(*cell, seed=seed)
    data = serde.serialize_proof(proof)
    assert serde.serialize_proof(serde.deserialize_proof(data)) == data


def test_the_fixture_round_trips():
    """The committed mini proof reads back and writes its own bytes."""
    data = FIXTURE.read_bytes()
    proof = serde.deserialize_proof(data)
    assert serde.serialize_proof(proof) == data == plain_serialize(proof)


# ---------------------------------------------------------------------------
# the codec on general objects
# ---------------------------------------------------------------------------


def random_int(rng) -> int:
    """An int of a random head width, either sign, up to 2^64 - 1."""
    bound = int(rng.choice([24, 256, 65536, 2**32, 2**64]))
    v = int(rng.integers(0, bound, dtype=np.uint64))
    return -1 - v if rng.random() < 0.3 else v


def random_leaf(rng):
    kind = int(rng.integers(0, 10))
    if kind == 0:
        return random_int(rng)
    if kind == 1:
        return bytes(rng.integers(0, 256, int(rng.integers(0, 30)),
                                  dtype=np.uint8))
    if kind == 2:
        return "".join(rng.choice(list("abcé✓"), int(rng.integers(0, 30))))
    if kind == 3:
        return None
    if kind == 4:
        return bool(rng.integers(0, 2))
    if kind == 5:
        return np.uint32(BOUNDARY[int(rng.integers(len(BOUNDARY)))])
    if kind == 6:
        return words(rng, (int(rng.integers(0, 40)),))
    if kind == 7:
        return words(rng, (int(rng.integers(0, 6)), int(rng.integers(0, 12))))
    if kind == 8:
        return words(rng, (2, 3, 4))
    return 2**32 + int(rng.integers(0, 2**31))


def random_obj(rng, depth: int = 0):
    kind = int(rng.integers(0, 4)) if depth < 4 else 3
    if kind == 0:
        return [random_obj(rng, depth + 1)
                for _ in range(int(rng.integers(0, 30)))]
    if kind == 1:
        return tuple(random_obj(rng, depth + 1)
                     for _ in range(int(rng.integers(0, 5))))
    if kind == 2:
        out = {}
        for _ in range(int(rng.integers(0, 8))):
            key = (random_int(rng) if rng.random() < 0.3
                   else str(rng.integers(0, 10**9)))
            out[key] = random_obj(rng, depth + 1)
        return out
    return random_leaf(rng)


def as_lists(obj):
    if isinstance(obj, dict):
        return {k: as_lists(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [as_lists(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.integer):
        return int(obj)
    return obj


@pytest.mark.parametrize("seed", range(8))
def test_random_objects_match_the_jax_codec(seed):
    """Random nested lists, tuples and dicts of ints of every head width
    (negatives and 2^32 and above too), bytes, str, None, bools, uint32
    scalars and uint32 arrays of shape [n], [n, m] and [2, 3, 4]: the same
    bytes as the JAX package's codec of the object with arrays as lists,
    and the same object back from cbor_loads."""
    rng = np.random.default_rng(seed)
    obj = [random_obj(rng) for _ in range(20)]
    want = jax_serde.cbor_dumps(as_lists(obj))
    assert serde.cbor_dumps(obj) == want == plain_dumps(obj)
    assert serde.cbor_loads(want) == jax_serde.cbor_loads(want)


@pytest.mark.parametrize("arr", [
    np.zeros(0, np.uint32), np.zeros((0, 5), np.uint32),
    np.zeros((3, 0), np.uint32), np.arange(24, dtype=np.uint32)[::3],
    np.arange(24, dtype=np.uint32).reshape(4, 6)[:, 1:4],
    np.arange(24, dtype=np.uint32).reshape(4, 6).T,
    np.array(BOUNDARY, dtype=">u4"), np.array(BOUNDARY, dtype=np.uint64),
    np.array([-1, 5, 2**40], dtype=np.int64), np.array(7, dtype=np.uint32),
    np.array([[[[1]]]], dtype=np.uint32), np.ones((1, 1, 1, 1, 1, 1), np.uint32),
    np.ones((2000, 0), np.uint32),
], ids=["empty", "0x5", "3x0", "strided", "columns", "transposed",
        "big-endian", "uint64", "int64", "0-d", "1x1x1x1", "1x1x1x1x1x1",
        "2000x0"])
def test_array_layouts(arr):
    """Every array is written as its tolist(): empty and degenerate shapes,
    strided and transposed views, other dtypes and byte orders, 0-d."""
    want = plain_dumps(arr)
    assert want == jax_serde.cbor_dumps(arr.tolist())
    assert serde.cbor_dumps(arr) == want
    assert serde.cbor_dumps({"a": [arr, arr]}) == plain_dumps({"a": [arr, arr]})


def test_unencodable_values_raise():
    for bad in (1.5, object(), bytearray(b"x"), np.float32(1)):
        with pytest.raises(TypeError, match="cannot CBOR-encode"):
            serde.cbor_dumps([1, {"k": bad}])


def test_cbor_write_checks_its_layout():
    """The native writer refuses marks and leaves that do not add up (a
    mark past the skeleton or before the last, a mark without a leaf or a
    leaf without one, a leaf of no dimensions), and writes a layout that
    does."""
    leaf = np.arange(3, dtype=np.uint32)
    assert native.cbor_write(bytearray(b"\x82\x01"), [2],
                             [leaf]) == b"\x82\x01\x83\x00\x01\x02"
    for marks, leaves in (([3], [leaf]), ([2, 1], [leaf, leaf]), ([2], []),
                          ([], [leaf]), ([2], [np.array(5, np.uint32)])):
        with pytest.raises(ValueError, match="do not add up"):
            native.cbor_write(bytearray(b"\x82\x01"), marks, leaves)


def test_cbor_dumps_has_no_fallback(monkeypatch, tmp_path):
    """With the writer's source missing (so no library can be built or
    loaded), cbor_dumps raises NativeRunError."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native_build, "CBOR_SRC", tmp_path / "missing.cpp")
    with pytest.raises(native.NativeRunError, match="unavailable"):
        serde.cbor_dumps({"a": np.arange(3, dtype=np.uint32)})


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------


def _counted(proof) -> tuple[int, int]:
    before = dict(serde.stats)
    serde.serialize_proof(proof)
    return (serde.stats["serializations"] - before["serializations"],
            serde.stats["int_words"] - before["int_words"])


def test_counter_on_the_fixture():
    """A proof's ints are only its skeleton: the fixture's serialization
    counts one serialization and under 64 int words."""
    calls, ints = _counted(serde.deserialize_proof(FIXTURE.read_bytes()))
    assert calls == 1 and 0 < ints < 64


@pytest.mark.parametrize("cell", [("sha2_chain", 21),
                                  ("fibonacci_poseidon2", 21)],
                         ids=["sha2_chain.21", "fibonacci_poseidon2.21"])
def test_counter_on_a_segment_proof(cell_proofs, cell):
    """The same at 2^21: one serialization, under 64 int words (meta's
    version, each chip's log_degree, the PoW witness) out of some
    170-430 thousand words."""
    proof = cell_proofs[cell]
    calls, ints = _counted(proof)
    assert calls == 1 and ints == 2 + len(proof.chip_proofs) < 64
    assert proof_words(proof) > 1000 * ints


def test_counter_counts_every_scalar_int():
    """int_words counts each int written one at a time, keys and ints
    inside arrays of other dtypes too; uint32 arrays count none."""
    before = serde.stats["int_words"]
    serde.cbor_dumps({1: [2, np.uint32(3), True, None],
                      "a": np.arange(5, dtype=np.uint32),
                      "b": np.arange(4, dtype=np.int64)})
    assert serde.stats["int_words"] - before == 3 + 4


def test_the_benchmark_reads_the_counter(monkeypatch):
    """proverbench's serialize_int_words_per_job reads serde.stats: None
    before a serialization, then the int words a serialization wrote, four
    for the fixture (meta's version, two log_degrees, the PoW witness)."""
    path = (CONFIGS.parent / "metrics" / "serialize_int_words_per_job.py")
    loader = importlib.util.spec_from_file_location("int_words_metric", path)
    metric = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(metric)
    monkeypatch.setattr(serde, "stats", {"serializations": 0, "int_words": 0})
    assert metric.read(None) is None
    proof = serde.deserialize_proof(FIXTURE.read_bytes())
    for _ in range(2):
        serde.serialize_proof(proof)
    assert metric.read(None) == 4
