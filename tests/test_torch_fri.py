"""The port's FRI (valida_tpu_torch.commit.fri) against the JAX package's
numpy path: tables, the fold, the grind, the final polynomial and whole
FRI proofs on random low-degree inputs, all exactly equal."""

import numpy as np
import pytest

from valida_tpu.commit import fri as rfri
from valida_tpu.crypto.challenger import DuplexChallenger as RefChallenger
from valida_tpu.field import babybear as rbb
from valida_tpu.poly import ntt as rntt
from valida_tpu_torch.commit import fri
from valida_tpu_torch.convert import from_reference, to_numpy
from valida_tpu_torch.crypto.challenger import DuplexChallenger

P = rbb.P


def _seeded_challengers(seed):
    pair = DuplexChallenger(), RefChallenger()
    for v in np.random.default_rng(seed).integers(0, P, size=11):
        for c in pair:
            c.observe(int(v))
    return pair


def _same_state(a, b):
    return (a.state == b.state and a.input_buffer == b.input_buffer
            and a.output_buffer == b.output_buffer)


@pytest.mark.parametrize("log_m,shift", [(1, 31), (2, 31), (5, 7), (9, 961),
                                         (12, 31)])
def test_x0_inv_table(log_m, shift):
    np.testing.assert_array_equal(fri._x0_inv_table(log_m, shift),
                                  rfri._x0_inv_table(log_m, shift))


@pytest.mark.parametrize("layer", [0, 1, 5])
def test_layer_shift_and_config_helpers(layer):
    assert fri.layer_shift(31, layer) == rfri.layer_shift(31, layer)
    for log_final in (0, 2):
        a = fri.FriConfig(log_final=log_final)
        b = rfri.FriConfig(log_final=log_final)
        assert fri.direct_open_threshold(a) == rfri.direct_open_threshold(b)
        for log_max, min_h in [(10, 10), (10, 2), (3, 1), (2, 2)]:
            assert (fri.fri_log_stop(a, log_max, min_h)
                    == rfri.fri_log_stop(b, log_max, min_h))
            assert (fri.is_direct_mat(min_h, log_max, layer)
                    == rfri.is_direct_mat(min_h, log_max, layer))
    assert fri._bitrev_int(0b1011, 6) == rfri._bitrev_int(0b1011, 6)
    nested = ((1, 2, 3, 4, 5), (6, 7, 8, 9, 10))
    assert fri.final_poly_coeffs(nested) == rfri.final_poly_coeffs(nested)
    assert fri.final_poly_coeffs(nested[0]) == rfri.final_poly_coeffs(nested[0])


@pytest.mark.parametrize("log_m", [1, 4, 9])
def test_fold_device(log_m):
    rng = np.random.default_rng(log_m)
    v = rng.integers(0, P, size=(1 << log_m, 5), dtype=np.uint32)
    v[0] = 0
    v[1] = P - 1
    beta = rng.integers(0, P, size=5, dtype=np.uint32)
    x0 = rfri._x0_inv_table(log_m, 31)
    got = fri.fold_device(from_reference(v), from_reference(beta),
                          from_reference(x0))
    np.testing.assert_array_equal(to_numpy(got),
                                  rfri.fold_device(v, beta, x0))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_grind_device_finds_the_same_smallest_witness(bits):
    got_c, want_c = _seeded_challengers(bits)
    check = got_c.clone()
    got = fri.grind_device(got_c, bits, "cpu")
    assert got == rfri.grind_device(want_c, bits)
    assert _same_state(got_c, want_c)
    # the smallest: no smaller witness passes
    for w in range(got):
        assert not check.clone().check_witness(bits, w)
    assert check.check_witness(bits, got)


def test_grind_device_equals_host_grind():
    a, _ = _seeded_challengers(40)
    b = a.clone()
    assert fri.grind_device(a, 6, "cpu") == b.grind(6)
    assert a.state == b.state


def _low_degree_evals(rng, log_m, log_blowup, shift):
    """[2^log_m, 5] ext Montgomery evaluations, in bit-reversed order over
    the coset, of a random polynomial of degree < 2^(log_m - log_blowup)."""
    m = 1 << log_m
    coeffs = np.zeros((m, 5), dtype=np.uint32)
    coeffs[: m >> log_blowup] = rng.integers(
        0, P, size=(m >> log_blowup, 5), dtype=np.uint32)
    evals = rntt.coset_eval_from_coeffs(rbb.to_monty(coeffs), shift)
    return evals[rntt.bitrev_indices(log_m)]


@pytest.mark.parametrize("log_final,log_stop", [(0, 1), (2, 3)])
def test_extract_final_poly(log_final, log_stop):
    rng = np.random.default_rng(log_final)
    log_max = 6
    s_fin = rfri.layer_shift(31, log_max - log_stop)
    cur = _low_degree_evals(rng, log_stop, 1, s_fin)
    got_c, want_c = _seeded_challengers(1)
    got = fri.extract_final_poly(
        from_reference(cur), fri.FriConfig(log_final=log_final), log_max,
        log_stop, 31, got_c)
    want = rfri.extract_final_poly(
        cur, rfri.FriConfig(log_final=log_final), log_max, log_stop, 31,
        want_c)
    assert got == want
    assert _same_state(got_c, want_c)


def test_extract_final_poly_rejects_a_high_degree_layer():
    cur = np.random.default_rng(2).integers(0, P, size=(8, 5), dtype=np.uint32)
    with pytest.raises(fri.FriError, match="degree bound"):
        fri.extract_final_poly(from_reference(cur),
                               fri.FriConfig(log_final=2), 6, 3, 31,
                               DuplexChallenger())


def _assert_same_fri_proof(got, want):
    assert len(got.commit_phase_commits) == len(want.commit_phase_commits)
    for a, b in zip(got.commit_phase_commits, want.commit_phase_commits):
        np.testing.assert_array_equal(a, b)
    assert got.final_poly == want.final_poly
    assert got.pow_witness == want.pow_witness
    assert len(got.query_proofs) == len(want.query_proofs)
    for qa, qb in zip(got.query_proofs, want.query_proofs):
        assert len(qa.commit_phase_openings) == len(qb.commit_phase_openings)
        for oa, ob in zip(qa.commit_phase_openings, qb.commit_phase_openings):
            np.testing.assert_array_equal(oa.pair_row, ob.pair_row)
            assert oa.pair_row.dtype == np.uint32
            np.testing.assert_array_equal(np.asarray(oa.path),
                                          np.asarray(ob.path))


@pytest.mark.parametrize("hasher", ["keccak", "poseidon2"])
@pytest.mark.parametrize("heights,log_final", [((7,), 0), ((8, 5), 0),
                                               ((8, 5), 2)])
def test_fri_prove_and_verify(hasher, heights, log_final):
    rng = np.random.default_rng(sum(heights) + log_final)
    reduced = {h: _low_degree_evals(rng, h, 1, 31) for h in heights}
    kw = dict(log_blowup=1, num_queries=6, proof_of_work_bits=3,
              hasher=hasher, log_final=log_final)
    got_c, want_c = _seeded_challengers(5)
    verifier_c = got_c.clone()
    got, got_idx = fri.fri_prove(
        {h: from_reference(v) for h, v in reduced.items()},
        fri.FriConfig(**kw), 31, got_c)
    want, want_idx = rfri.fri_prove(reduced, rfri.FriConfig(**kw), 31, want_c)
    assert got_idx == want_idx
    _assert_same_fri_proof(got, want)
    assert _same_state(got_c, want_c)

    # the port's verifier replays the transcript and accepts each query
    config = fri.FriConfig(**kw)
    log_max = max(heights)
    betas, indices = fri.fri_verify_challenges(got, config, log_max,
                                               verifier_c)
    assert indices == got_idx
    canon = {h: rbb.from_monty(v) for h, v in reduced.items()}
    ros = [{h: tuple(int(x) for x in canon[h][i >> (log_max - h)])
            for h in heights} for i in indices]
    fri.verify_queries_fold(got.query_proofs, got, config, betas, indices,
                            log_max, 31, ros)
    fri.verify_query_fold(got.query_proofs[0], got, config, betas,
                          indices[0], log_max, 31, ros[0])
    # a wrong reduced opening, a wrong pair row and a dropped layer fail
    bad = dict(ros[2])
    bad[log_max] = tuple((x + 1) % P for x in bad[log_max])
    with pytest.raises(fri.FriError):
        fri.verify_queries_fold(got.query_proofs, got, config, betas,
                                indices, log_max, 31,
                                ros[:2] + [bad] + ros[3:])
    row = got.query_proofs[1].commit_phase_openings[0].pair_row
    row[0] = (int(row[0]) + 1) % P
    with pytest.raises(fri.FriError, match="Merkle path"):
        fri.verify_queries_fold(got.query_proofs, got, config, betas,
                                indices, log_max, 31, ros)
    row[0] = (int(row[0]) - 1) % P
    got.commit_phase_commits.pop()
    with pytest.raises(fri.FriError, match="number of commit-phase layers"):
        fri.verify_queries_fold(got.query_proofs, got, config, betas,
                                indices, log_max, 31, ros)


def test_wrong_witness_fails_the_proof_of_work_check():
    proof = fri.FriProof(commit_phase_commits=[], final_poly=(1, 2, 3, 4, 5),
                         pow_witness=0, query_proofs=[])
    config = fri.FriConfig(proof_of_work_bits=16, num_queries=1)
    c = DuplexChallenger()
    probe = c.clone()
    probe.observe_ext(proof.final_poly)
    proof.pow_witness = next(w for w in range(100)
                             if not probe.clone().check_witness(16, w))
    with pytest.raises(fri.FriError, match="proof-of-work"):
        fri.fri_verify_challenges(proof, config, 4, c)


def test_final_poly_shape_is_checked():
    config = fri.FriConfig(log_final=0)
    nested = fri.FriProof([], ((1, 2, 3, 4, 5),), 0, [])
    with pytest.raises(fri.FriError, match="single constant"):
        fri.check_final_poly_shape(nested, config, 1)
    config = fri.FriConfig(log_final=2)
    with pytest.raises(fri.FriError, match="coefficients"):
        fri.check_final_poly_shape(nested, config, 3)
