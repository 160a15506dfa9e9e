"""The port's machine prover and verifier (valida_tpu_torch.machine)
against the JAX package's numpy path: the slice as a whole.  Proofs are
compared as bytes (tooling/serde.py)."""

import copy
import hashlib

import numpy as np
import pytest

from valida_tpu import backend
from valida_tpu.commit import fri as rfri
from valida_tpu.commit import pcs as rpcs
from valida_tpu.core import config as rconfig
from valida_tpu.core import proof as rproof
from valida_tpu.machine import examples as rexamples
from valida_tpu.machine import verifier as rverifier
from valida_tpu.tooling import serde as rserde
from valida_tpu_torch.convert import (machine_proof_from_reference,
                                      machine_proof_to_reference)
from valida_tpu_torch.core import config
from valida_tpu_torch.field import babybear as bb
from valida_tpu_torch.field import ext as extf
from valida_tpu_torch.machine import examples, verifier
from valida_tpu_torch.tooling import serde


def reference_machine_digest(n_pairs: int, hasher: str) -> str:
    """SHA-256 of the serialized proof of `random_ragged_machine(n_pairs,
    seed=7)` under `default_config(hasher=hasher)`, as the JAX package's
    numpy path makes it (chip_smoke.py's paths (f') and (g'), 2^14 pairs:
    about 15 s each)."""
    m = rexamples.random_ragged_machine(n_pairs, seed=7)
    with backend.use_backend("numpy"):
        proof = m.prove(rconfig.default_config(hasher=hasher))
    return hashlib.sha256(rserde.serialize_proof(proof)).hexdigest()


def reference_machine_roots(n_pairs: int) -> list:
    """The preprocessed and main-trace commitment roots (hex of the
    little-endian words) of `random_ragged_machine(n_pairs, seed=7)` under
    `default_config()`, as the JAX package's numpy PCS commits them: no
    challenge is needed for either (chip_smoke.py's path (f), 2^20
    pairs)."""
    m = rexamples.random_ragged_machine(n_pairs, seed=7)
    pcs = rconfig.default_config().pcs
    chips = m.chips()
    prep = [np.asarray(c.preprocessed_trace(), dtype=np.uint32)
            for c in chips if c.preprocessed_trace() is not None]
    main = [np.asarray(c.generate_trace(m), dtype=np.uint32) for c in chips]
    with backend.use_backend("numpy"):
        return [np.asarray(pcs.commit_batches(mats)[0], dtype="<u4")
                .tobytes().hex() for mats in (prep, main)]


REF_MODULES = (rproof, rfri, rpcs)
FIXTURE = "tests/fixtures/mini_proof_v1.cbor"


def _fixture_bytes():
    with open(FIXTURE, "rb") as f:
        return f.read()


def test_default_config_needs_a_gpu_here():
    """No GPU in this process: the default device raises, no CPU
    fallback."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        config.default_config()
    with pytest.raises(RuntimeError, match="cuda"):
        config.test_config()


def test_fixture_bytes_are_reproduced():
    """The port's proof of the fixture's machine serializes to exactly the
    JAX package's committed golden proof, and the port verifies it."""
    m = examples.random_mini_machine(48, seed=3)
    cfg = config.default_config(num_queries=3, proof_of_work_bits=1,
                                device="cpu")
    blob = _fixture_bytes()
    assert serde.serialize_proof(m.prove(cfg)) == blob
    m.verify(cfg, serde.deserialize_proof(blob))


def test_serde_codec_roundtrip():
    """The codec's own round trip, and the meta block with a config."""
    obj = {"a": [0, 23, 24, 255, 256, 65535, 65536, 2**32, -1, -25],
           "b": b"\x00\x01", "c": None, "d": True, "e": "text"}
    assert serde.cbor_loads(serde.cbor_dumps(obj)) == obj
    assert serde.cbor_dumps(obj) == rserde.cbor_dumps(obj)
    proof = serde.deserialize_proof(_fixture_bytes())
    cfg = config.test_config(device="cpu")
    meta = serde.proof_meta(serde.serialize_proof(proof, cfg))
    assert meta == {"v": 1, "poseidon": "p3rng", "hasher": "keccak"}
    with pytest.raises(ValueError, match="trailing"):
        serde.cbor_loads(serde.cbor_dumps(1) + b"\x00")


@pytest.fixture(scope="module")
def ragged_proofs():
    """{hasher: (ref machine, port machine, ref config, port config, ref
    proof, port proof)} for random_ragged_machine(32, seed=7) under
    test_config(), with Keccak and with Poseidon2 trees."""
    out = {}
    for hasher in ("keccak", "poseidon2"):
        ref_m = rexamples.random_ragged_machine(32, seed=7)
        m = examples.random_ragged_machine(32, seed=7)
        ref_cfg = rconfig.default_config(num_queries=4, proof_of_work_bits=2,
                                         hasher=hasher)
        cfg = config.default_config(num_queries=4, proof_of_work_bits=2,
                                    hasher=hasher, device="cpu")
        with backend.use_backend("numpy"):
            ref_proof = ref_m.prove(ref_cfg)
        out[hasher] = (ref_m, m, ref_cfg, cfg, ref_proof, m.prove(cfg))
    return out


@pytest.mark.parametrize("hasher", ["keccak", "poseidon2"])
def test_ragged_proof_bytes_match_reference(ragged_proofs, hasher):
    _ref_m, _m, _rc, _c, ref_proof, proof = ragged_proofs[hasher]
    assert serde.serialize_proof(proof) == rserde.serialize_proof(ref_proof)
    assert sorted(cp.log_degree for cp in proof.chip_proofs) == [0, 2, 4, 5]


@pytest.mark.parametrize("hasher", ["keccak", "poseidon2"])
def test_ragged_cross_verification(ragged_proofs, hasher):
    """Each package's verifier accepts the other's proof, carried across
    by convert.machine_proof_* and by the bytes."""
    ref_m, m, ref_cfg, cfg, ref_proof, proof = ragged_proofs[hasher]
    with backend.use_backend("numpy"):
        ref_m.verify(ref_cfg, machine_proof_to_reference(proof, REF_MODULES))
        ref_m.verify(ref_cfg, rserde.deserialize_proof(
            serde.serialize_proof(proof)))
    m.verify(cfg, machine_proof_from_reference(ref_proof))
    m.verify(cfg, serde.deserialize_proof(rserde.serialize_proof(ref_proof)))
    # the conversions keep every value: back and forth gives the bytes
    assert serde.serialize_proof(machine_proof_from_reference(
        machine_proof_to_reference(proof, REF_MODULES))) \
        == serde.serialize_proof(proof)


# ---------------------------------------------------------------------------
# tampered proofs: the same VerificationError subclass in both packages
# (the cases of tests/test_soundness.py)
# ---------------------------------------------------------------------------


def _flip_digest(attr, word):
    def f(p):
        d = getattr(p.commitments, attr).copy()
        d[word] ^= 1
        setattr(p.commitments, attr, d)
    return f


def _bump_opened(attr, coeff, delta):
    def f(p):
        vals = getattr(p.chip_proofs[0].opened_values, attr)
        v = list(vals[0])
        v[coeff] = (v[coeff] + delta) % bb.P
        vals[0] = tuple(v)
    return f


def _cumulative_sum_pair(p):
    delta = (1, 0, 0, 0, 0)
    p.chip_proofs[0].cumulative_sum = extf.e_add(
        tuple(p.chip_proofs[0].cumulative_sum), delta)
    p.chip_proofs[1].cumulative_sum = extf.e_sub(
        tuple(p.chip_proofs[1].cumulative_sum), delta)


def _final_poly(p):
    fp = list(p.opening_proof.fri.final_poly)
    fp[0] = (fp[0] + 1) % bb.P
    p.opening_proof.fri.final_poly = tuple(fp)


def _pow_witness(p):
    p.opening_proof.fri.pow_witness += 1


def _query_row(p):
    op = p.opening_proof.query_proofs[0].input_openings[0]
    row = op.opened_rows[0].copy()
    row[0] ^= 1
    op.opened_rows[0] = row


def _merkle_path(p):
    op = p.opening_proof.query_proofs[0].input_openings[0]
    path = [d.copy() for d in op.path]
    path[0][0] ^= 1
    op.path = path


def _commit_phase_opening(p):
    op = p.opening_proof.fri.query_proofs[0].commit_phase_openings[0]
    row = op.pair_row.copy()
    row[0] ^= 1
    op.pair_row = row


def _log_degree(p):
    p.chip_proofs[0].log_degree += 1


def _drop_chip(p):
    p.chip_proofs.pop()


def _short_opening(p):
    p.chip_proofs[0].opened_values.trace_local.pop()


TAMPERS = {
    "main commitment": _flip_digest("main_trace", 0),
    "perm commitment": _flip_digest("perm_trace", 3),
    "quotient commitment": _flip_digest("quotient_chunks", 7),
    "preprocessed commitment": _flip_digest("preprocessed", 2),
    "opened trace value": _bump_opened("trace_local", 0, 1),
    "perm opening": _bump_opened("permutation_local", 2, 5),
    "quotient opening": _bump_opened("quotient_chunks", 1, 1),
    "cumulative sum pair": _cumulative_sum_pair,
    "fri final poly": _final_poly,
    "pow witness": _pow_witness,
    "query row": _query_row,
    "merkle path": _merkle_path,
    "commit phase opening": _commit_phase_opening,
    "log degree": _log_degree,
    "chip count": _drop_chip,
    "opened shape": _short_opening,
}


@pytest.fixture(scope="module")
def mini_proofs():
    ref_m = rexamples.MiniMachine([(1, 2), (3, 4), (7, 7), (15, 0)])
    m = examples.MiniMachine([(1, 2), (3, 4), (7, 7), (15, 0)])
    ref_cfg = rconfig.test_config(debug_checks=False)
    cfg = config.test_config(debug_checks=False, device="cpu")
    with backend.use_backend("numpy"):
        ref_proof = ref_m.prove(ref_cfg)
    proof = m.prove(cfg)
    assert serde.serialize_proof(proof) == rserde.serialize_proof(ref_proof)
    return ref_m, m, ref_cfg, cfg, ref_proof, proof


def _rejection(verify, proof):
    with pytest.raises(Exception) as e:
        verify(proof)
    return type(e.value)


@pytest.mark.parametrize("case", list(TAMPERS))
def test_tampered_proof_same_error(mini_proofs, case):
    ref_m, m, ref_cfg, cfg, ref_proof, proof = mini_proofs
    ref_bad, bad = copy.deepcopy(ref_proof), copy.deepcopy(proof)
    TAMPERS[case](ref_bad)
    TAMPERS[case](bad)
    with backend.use_backend("numpy"):
        want = _rejection(lambda p: ref_m.verify(ref_cfg, p), ref_bad)
    got = _rejection(lambda p: m.verify(cfg, p), bad)
    assert issubclass(want, rverifier.VerificationError)
    assert issubclass(got, verifier.VerificationError)
    assert got.__name__ == want.__name__


@pytest.mark.parametrize("case", ["opened trace value", "cumulative sum"])
def test_full_width_tampers_same_error(ragged_proofs, case):
    """chip_smoke.py's two tampers of path (f), on the ragged machine at a
    small size: both packages raise the class chip_smoke.py expects."""
    import chip_smoke

    tamper, expected = chip_smoke.TAMPERS[case]
    ref_m, m, ref_cfg, cfg, ref_proof, proof = ragged_proofs["keccak"]
    with backend.use_backend("numpy"):
        want = _rejection(lambda p: ref_m.verify(ref_cfg, p),
                          tamper(ref_proof))
    got = _rejection(lambda p: m.verify(cfg, p), tamper(proof))
    assert got.__name__ == want.__name__ == expected


@pytest.mark.parametrize("machine", ["mini", "ragged"])
def test_bus_imbalance_fails_the_debug_check(machine):
    """A lost or extra range receive: both provers stop with the
    bus-imbalance AssertionError of the debug checks."""
    if machine == "mini":
        ref_m = rexamples.MiniMachine([(1, 2), (3, 4)])
        m = examples.MiniMachine([(1, 2), (3, 4)])
        for mm in (ref_m, m):
            mm.range.counts[1] += 1
    else:
        ref_m = rexamples.random_ragged_machine(32, seed=7)
        m = examples.random_ragged_machine(32, seed=7)
        for mm in (ref_m, m):
            mm.range.counts[mm.onerow.value] -= 1
    with backend.use_backend("numpy"):
        with pytest.raises(AssertionError, match="bus imbalance") as e:
            ref_m.prove(rconfig.test_config())
    with pytest.raises(AssertionError, match="bus imbalance") as e2:
        m.prove(config.test_config(device="cpu"))
    assert str(e.value) == str(e2.value)
