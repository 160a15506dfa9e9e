"""The port's PCS (valida_tpu_torch.commit.pcs) against the JAX package's
numpy path, the slice as a whole."""

import numpy as np
import pytest

import chip_smoke
from valida_tpu import backend
from valida_tpu.commit import fri as rfri
from valida_tpu.commit import pcs as rpcs
from valida_tpu.commit.fri import FriConfig as RefFriConfig
from valida_tpu.commit.pcs import TwoAdicFriPcs as RefPcs
from valida_tpu.crypto.challenger import DuplexChallenger as RefChallenger
from valida_tpu.field import babybear as rbb
from valida_tpu_torch.commit.fri import FriConfig, FriError
from valida_tpu_torch.commit.pcs import TwoAdicFriPcs
from valida_tpu_torch.convert import (proof_from_reference,
                                      proof_to_reference, to_numpy)
from valida_tpu_torch.crypto.challenger import DuplexChallenger


def reference_pcs_digests(path: str) -> dict:
    """`chip_smoke.proof_digest` of the PCS proof of chip_smoke's path
    `path` ("d'" or "e"), with the two commitment roots, as the JAX
    package's numpy path computes them.  Minutes at those sizes."""
    shapes, hasher = chip_smoke.PCS_PATHS[path][:2]
    pcs = RefPcs(RefFriConfig(hasher=hasher, **chip_smoke.PCS_FRI),
                 coset_shift=rbb.GENERATOR)
    with backend.use_backend("numpy"):
        rounds, opened, proof = chip_smoke.pcs_prove(
            pcs, RefChallenger(), chip_smoke.pcs_matrices(shapes),
            chip_smoke.pcs_points(shapes))
    out = chip_smoke.proof_digest(opened, proof)
    out["roots"] = [chip_smoke.words_hex(root) for root, _ in rounds]
    return out


def reference_pcs_roots(path: str) -> list:
    """The two commitment roots of chip_smoke's path `path`, as the JAX
    package's numpy path computes them (for "d", at full width, about half
    an hour)."""
    shapes, hasher = chip_smoke.PCS_PATHS[path][:2]
    pcs = RefPcs(RefFriConfig(hasher=hasher, **chip_smoke.PCS_FRI),
                 coset_shift=rbb.GENERATOR)
    mats = chip_smoke.pcs_matrices(shapes)
    with backend.use_backend("numpy"):
        return [chip_smoke.words_hex(pcs.commit_batches(batch)[0])
                for batch in (mats[:2], mats[2:])]


# ---------------------------------------------------------------------------
# the slice as a whole, at small sizes, for both hashers
# ---------------------------------------------------------------------------

P = rbb.P
Z = chip_smoke.PCS_Z
Z2 = tuple(c * 7 % P for c in Z)

# name -> (rounds of matrix shapes (log_n, cols), per-round domain shifts or
# None, points per round and matrix, FRI parameters, coset shift)
CASES = {
    "single_16x3": ([[(4, 3)]], None, [[[Z]]], dict(), 31),
    "two_rounds_mixed_heights_two_points": (
        [[(6, 7), (3, 4), (6, 2)], [(5, 2)]], None,
        [[[Z, Z2], [Z], [Z2]], [[Z]]], dict(), 31),
    "shifted_domain": (
        [[(5, 3), (4, 2)], [(5, 1)]], [[5, 1], [961]],
        [[[Z], [Z, Z2]], [[Z2]]], dict(), 7),
    "log_final_2_with_direct_matrix": (
        [[(6, 5), (1, 3)], [(0, 2), (4, 1)]], None,
        [[[Z], [Z2]], [[Z], [Z]]], dict(log_final=2), 31),
    "1024x20": ([[(10, 20)]], None, [[[Z, Z2]]], dict(num_queries=8), 31),
}
SMALL_FRI = dict(log_blowup=1, num_queries=5, proof_of_work_bits=4)


def _prove(pcs, challenger, mats, shifts, points):
    rounds = [pcs.commit_batches(batch, None if shifts is None else s)
              for batch, s in zip(mats, shifts or [None] * len(mats))]
    for root, _ in rounds:
        challenger.observe_digest(root)
    opened, proof = pcs.open_multi_batches(
        [(data, pts) for (_, data), pts in zip(rounds, points)], challenger)
    return rounds, opened, proof


def _verify(pcs, challenger, roots, points, dims, opened, proof):
    for root in roots:
        challenger.observe_digest(root)
    pcs.verify_multi_batches(list(zip(roots, points)), dims, opened, proof,
                             challenger)


def _assert_same_proof(got, want):
    assert chip_smoke.proof_digest([], got) == chip_smoke.proof_digest([], want)
    assert got.fri.final_poly == want.fri.final_poly
    assert got.fri.pow_witness == want.fri.pow_witness
    assert len(got.query_proofs) == len(want.query_proofs)
    assert len(got.direct_polys) == len(want.direct_polys)
    for a, b in zip(got.direct_polys, want.direct_polys):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.fri.commit_phase_commits,
                    want.fri.commit_phase_commits):
        np.testing.assert_array_equal(a, b)
    for qa, qb in zip(got.query_proofs, want.query_proofs):
        assert len(qa.input_openings) == len(qb.input_openings)
        for oa, ob in zip(qa.input_openings, qb.input_openings):
            assert len(oa.opened_rows) == len(ob.opened_rows)
            for ra, rb in zip(oa.opened_rows, ob.opened_rows):
                np.testing.assert_array_equal(ra, rb)
            np.testing.assert_array_equal(np.asarray(oa.path),
                                          np.asarray(ob.path))
        fa, fb = qa.fri_query, qb.fri_query
        assert len(fa.commit_phase_openings) == len(fb.commit_phase_openings)
        for oa, ob in zip(fa.commit_phase_openings, fb.commit_phase_openings):
            np.testing.assert_array_equal(oa.pair_row, ob.pair_row)
            np.testing.assert_array_equal(np.asarray(oa.path),
                                          np.asarray(ob.path))


@pytest.mark.parametrize("hasher", ["keccak", "poseidon2"])
@pytest.mark.parametrize("case", list(CASES))
def test_pcs_matches_reference(case, hasher):
    shapes, shifts, points, fri_kw, coset_shift = CASES[case]
    rng = np.random.default_rng(len(case))
    mats = [[rng.integers(0, P, size=(1 << n, c), dtype=np.uint32)
             for n, c in batch] for batch in shapes]
    dims = [[(1 << n, c) for n, c in batch] for batch in shapes]
    kw = dict(SMALL_FRI, hasher=hasher, **fri_kw)
    pcs = TwoAdicFriPcs(FriConfig(**kw), coset_shift, device="cpu")
    ref = RefPcs(RefFriConfig(**kw), coset_shift)

    rounds, opened, proof = _prove(pcs, DuplexChallenger(), mats, shifts,
                                   points)
    with backend.use_backend("numpy"):
        r_rounds, r_opened, r_proof = _prove(ref, RefChallenger(), mats,
                                             shifts, points)

    # commitments, prover data, opened values, every field of the proof
    roots = [root for root, _ in rounds]
    for (root, data), (r_root, r_data) in zip(rounds, r_rounds):
        np.testing.assert_array_equal(root, r_root)
        assert data.log_heights == r_data.log_heights
        for a, b in zip(data.coeffs, r_data.coeffs):
            np.testing.assert_array_equal(to_numpy(a), b)
        for a, b in zip(pcs.get_ldes(data), ref.get_ldes(r_data)):
            np.testing.assert_array_equal(to_numpy(a), b)
    assert opened == r_opened
    _assert_same_proof(proof, r_proof)
    assert (chip_smoke.proof_digest(opened, proof)
            == chip_smoke.proof_digest(r_opened, r_proof))
    if fri_kw.get("log_final"):
        assert len(proof.direct_polys) == 2

    # each verifier accepts the other's proof, carried across
    _verify(pcs, DuplexChallenger(), roots, points, dims, opened, proof)
    _verify(pcs, DuplexChallenger(), roots, points, dims, r_opened,
            proof_from_reference(r_proof))
    _verify(ref, RefChallenger(), roots, points, dims, opened,
            proof_to_reference(proof, rfri, rpcs))
    _assert_same_proof(proof_from_reference(r_proof), proof)

    # a changed opened value and a wrong root are rejected
    bad = [[[list(pt) for pt in mat] for mat in rnd] for rnd in opened]
    v = bad[-1][-1][0][0]
    bad[-1][-1][0][0] = (v[0], (v[1] + 1) % P) + tuple(v[2:])
    with pytest.raises(FriError):
        _verify(pcs, DuplexChallenger(), roots, points, dims, bad, proof)
    wrong = [r.copy() for r in roots]
    wrong[0][3] ^= 1
    with pytest.raises(FriError):
        _verify(pcs, DuplexChallenger(), wrong, points, dims, opened, proof)


def test_tampered_proofs_are_rejected_with_fri_error():
    shapes, shifts, points, fri_kw, coset_shift = CASES[
        "two_rounds_mixed_heights_two_points"]
    rng = np.random.default_rng(9)
    mats = [[rng.integers(0, P, size=(1 << n, c), dtype=np.uint32)
             for n, c in batch] for batch in shapes]
    dims = [[(1 << n, c) for n, c in batch] for batch in shapes]
    pcs = TwoAdicFriPcs(FriConfig(hasher="poseidon2", **SMALL_FRI),
                        coset_shift, device="cpu")
    rounds, opened, proof = _prove(pcs, DuplexChallenger(), mats, shifts,
                                   points)
    roots = [root for root, _ in rounds]

    def rejected(p, match=None):
        with pytest.raises(FriError, match=match):
            _verify(pcs, DuplexChallenger(), roots, points, dims, opened, p)

    p = proof_from_reference(proof)  # a deep copy through the converter
    p.query_proofs[2].input_openings[0].opened_rows[1][0] ^= 1
    rejected(p, "bad input opening")
    p = proof_from_reference(proof)
    p.query_proofs[1].input_openings[1].path[0][5] ^= 1
    rejected(p, "bad input opening")
    p = proof_from_reference(proof)
    p.fri.final_poly = tuple((x + 1) % P for x in p.fri.final_poly)
    rejected(p)
    p = proof_from_reference(proof)
    p.fri.pow_witness += 1
    rejected(p)
    p = proof_from_reference(proof)
    p.query_proofs.pop()
    rejected(p, "wrong query count")
    p = proof_from_reference(proof)
    p.direct_polys.append(np.zeros((2, 2), np.uint32))
    rejected(p, "unexpected extra")


def test_pcs_digest_constants_have_both_hashers():
    for path in ("d'", "e"):
        assert set(chip_smoke.PCS_GOLDEN[path]) == {"opened", "proof",
                                                    "roots"}
    assert set(chip_smoke.PCS_GOLDEN["d"]) == {"roots"}
    assert set(chip_smoke.PCS_GOLDEN) == set(chip_smoke.PCS_PATHS)
    # the opened values do not depend on the Merkle hasher
    assert (chip_smoke.PCS_GOLDEN["d'"]["opened"]
            == chip_smoke.PCS_GOLDEN["e"]["opened"])
    assert (chip_smoke.PCS_GOLDEN["d'"]["proof"]
            != chip_smoke.PCS_GOLDEN["e"]["proof"])


def test_chip_smoke_pcs_helpers_on_a_small_shape():
    """chip_smoke's own prove and verify helpers, through the port on the
    CPU at a small shape, against the JAX package's digest."""
    shapes = ((6, 9), (3, 4), (6, 2))
    kw = dict(SMALL_FRI, hasher="poseidon2")
    points = chip_smoke.pcs_points(shapes)
    mats = chip_smoke.pcs_matrices(shapes)
    pcs = TwoAdicFriPcs(FriConfig(**kw), device="cpu")
    rounds, opened, proof = chip_smoke.pcs_prove(pcs, DuplexChallenger(),
                                                 mats, points)
    with backend.use_backend("numpy"):
        _, r_opened, r_proof = chip_smoke.pcs_prove(
            RefPcs(RefFriConfig(**kw)), RefChallenger(), mats, points)
    assert (chip_smoke.proof_digest(opened, proof)
            == chip_smoke.proof_digest(r_opened, r_proof))
    chip_smoke.pcs_verify(pcs, DuplexChallenger(), shapes,
                          [root for root, _ in rounds], points, opened, proof)
