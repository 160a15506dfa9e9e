"""The port's distributed primitives (valida_tpu_torch.parallel) on gloo
ranks on the CPU, against the JAX package's numpy path: `dist_dif` and
`dist_coset_lde` blocks against `ntt.dif` and `ntt.coset_lde`,
`dist_coeffs` and `dist_eval` against `ntt.coset_intt` and
`ntt.coset_eval_from_coeffs`, the sharded
commit roots against `keccak256_words` trees, φ's last row against a
cumulative sum mod p, and the dry run.

Ranks are spawned once per world size (2, 4 and 8): a module fixture runs
every case of that size in the ranks, whose results come back through
files (`run_ranks`), and each test reads its case.  The JAX package is
imported only in this process, inside the reference functions, so the
ranks never load it.  Every collective and every join has a time bound.
"""

import numpy as np
import pytest
import torch

from valida_tpu_torch.convert import from_reference, to_numpy
from valida_tpu_torch.field import babybear as pbb
from valida_tpu_torch.parallel import dist_ntt, mesh as pmesh
from valida_tpu_torch.parallel.dryrun import dryrun_multichip, run_ranks

P = pbb.P
DIF_CASES = [(10, 4), (14, 3), (17, 5)]  # tests/test_dist_ntt.py's
PROVE_MESHES = [(1, 2), (2, 2), (1, 4)]  # (dp, sp)
PROVE_SHAPE = (2, 1 << 9, 5, 4)  # B, N, C, K: the LDE runs dist_coset_lde
EVAL_SHIFTS = (pbb.GENERATOR, pbb.h_exp(pbb.GENERATOR, 4))  # dshift, shift
RANK_TIMEOUT_S = 120


def _dif_input(log_n, cols):
    rng = np.random.default_rng(21)
    return rng.integers(0, P, size=(1 << log_n, cols), dtype=np.uint32)


def _lde_input():
    rng = np.random.default_rng(22)
    return rng.integers(0, P, size=(1 << 11, 6), dtype=np.uint32)


def _prove_inputs():
    b, n, c, k = PROVE_SHAPE
    rng = np.random.default_rng(23)
    return (rng.integers(0, P, size=(b, n, c), dtype=np.uint32),
            rng.integers(0, P, size=(b, n, k, 5), dtype=np.uint32),
            rng.integers(0, 3, size=(b, n, k), dtype=np.uint32))


def _cases(world):
    cases = [("applies",), ("mesh errors",), ("dryrun",)] if world < 8 else []
    for log_n, cols in DIF_CASES if world < 8 else DIF_CASES[:1]:
        cases += [("dif", log_n, cols, False), ("dif", log_n, cols, True)]
    if world < 8:
        cases += [("lde",), ("eval",), ("phi",)]
    cases += [("prove", dp, sp) for dp, sp in PROVE_MESHES
              if dp * sp == world]
    return cases


def _block(x, rank, world):
    n = x.shape[0] // world
    return from_reference(x[rank * n:(rank + 1) * n])


def _run_case(case, world, rank, mesh):
    kind = case[0]
    if kind == "dif":
        _, log_n, cols, inverse = case
        x = _block(_dif_input(log_n, cols), rank, world)
        return to_numpy(dist_ntt.dist_dif(x, mesh, "sp", inverse))
    if kind == "lde":
        x = pbb.to_monty(_block(_lde_input(), rank, world))
        return to_numpy(dist_ntt.dist_coset_lde(x, mesh, 1, pbb.GENERATOR))
    if kind == "eval":  # coefficients of dshift·H_N's values, on shift·H_N
        dshift, shift = EVAL_SHIFTS
        x = pbb.to_monty(_block(_lde_input(), rank, world))
        c = dist_ntt.dist_coeffs(x, mesh, "sp", dshift)
        return to_numpy(c), to_numpy(dist_ntt.dist_eval(c, mesh, shift))
    if kind == "phi":  # this rank's row block of every trace's φ
        _traces, q, counts = _prove_inputs()
        n = q.shape[1] // world
        rows = slice(rank * n, (rank + 1) * n)
        return to_numpy(pmesh.logup_phi_step(
            from_reference(q[:, rows]), from_reference(counts[:, rows]),
            mesh))
    if kind == "prove":
        _, dp, sp = case
        roots, phi = pmesh.sharded_prove_fn(
            pmesh.make_mesh(world, dp=dp, device="cpu"))(*_prove_inputs())
        return to_numpy(roots), to_numpy(phi)
    if kind == "dryrun":
        return dryrun_multichip(world, "cpu")
    if kind == "applies":
        return {(log_h, axis): dist_ntt.dist_dif_applies(log_h, mesh, axis)
                for log_h in range(5, 11) for axis in ("sp", "dp", "tp")}
    if kind == "mesh errors":
        errors = {}
        for args in [(world + 1, 1), (world, 3), (world, 0)]:
            try:
                pmesh.make_mesh(*args, device="cpu")
            except ValueError as e:
                errors[args] = str(e)
        try:
            pmesh.logup_phi_step(torch.zeros(1, 4, 3, 5, dtype=torch.int32),
                                 torch.zeros(1, 4, 3, dtype=torch.int32),
                                 mesh)
        except ValueError as e:
            errors["K = 3"] = str(e)
        return errors
    raise ValueError(case)


def _rank_cases(world, cases):
    """Run in each rank: every case on a (1, world) mesh, or its own."""
    import sys

    import torch.distributed as dist

    if "jax" in sys.modules:
        raise RuntimeError("a rank imported jax")
    mesh = pmesh.make_mesh(world, dp=1, device="cpu")
    return {case: _run_case(case, world, dist.get_rank(), mesh)
            for case in cases}


@pytest.fixture(scope="module")
def ranks():
    """results(world) -> [each rank's {case: result}], ranks spawned once
    per world size."""
    cache = {}

    def results(world):
        if world not in cache:
            cache[world] = run_ranks(_rank_cases, world, "cpu", world,
                                     _cases(world), timeout_s=RANK_TIMEOUT_S)
        return cache[world]

    return results


def _gathered(per_rank, case):
    return np.concatenate([r[case] for r in per_rank], axis=0)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n,cols", DIF_CASES)
def test_dist_dif_matches_dif(ranks, world, log_n, cols, inverse):
    from valida_tpu.poly import ntt as nttm

    want = nttm.dif(_dif_input(log_n, cols), inverse=inverse)
    got = _gathered(ranks(world), ("dif", log_n, cols, inverse))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("inverse", [False, True])
def test_dist_dif_on_8_ranks(ranks, inverse):
    from valida_tpu.poly import ntt as nttm

    want = nttm.dif(_dif_input(10, 4), inverse=inverse)
    assert np.array_equal(_gathered(ranks(8), ("dif", 10, 4, inverse)), want)


@pytest.mark.parametrize("world", [2, 4])
def test_dist_coset_lde_matches_coset_lde(ranks, world):
    from valida_tpu.field import babybear as bb
    from valida_tpu.poly import ntt as nttm

    want = nttm.coset_lde(bb.to_monty(_lde_input()), 1, bb.GENERATOR,
                          out_bitrev=True)
    assert np.array_equal(_gathered(ranks(world), ("lde",)), want)


@pytest.mark.parametrize("world", [2, 4])
def test_dist_coeffs_and_eval_match_ntt(ranks, world):
    """dist_coeffs' blocks are the coset inverse transform in bit-reversed
    order; dist_eval's, the coset evaluation of those coefficients in
    natural order."""
    from valida_tpu.field import babybear as bb
    from valida_tpu.poly import ntt as nttm

    dshift, shift = EVAL_SHIFTS
    coeffs = nttm.coset_intt(bb.to_monty(_lde_input()), dshift)
    per_rank = ranks(world)
    got_c = np.concatenate([r[("eval",)][0] for r in per_rank])
    got_e = np.concatenate([r[("eval",)][1] for r in per_rank])
    assert np.array_equal(got_c, coeffs[nttm.bitrev_indices(11)])
    assert np.array_equal(got_e, nttm.coset_eval_from_coeffs(coeffs, shift))


def reference_prove(traces, q, counts):
    """(roots [B, 8], φ's last row [B, 5]) by the JAX package's numpy path:
    each trace's Keccak tree over its bit-reversed blowup-2 LDE, and the
    sum mod p of every row's Σ_k q_k·count_k."""
    from valida_tpu.crypto import keccak
    from valida_tpu.field import babybear as bb
    from valida_tpu.poly import ntt as nttm

    roots = []
    for t in traces:
        rows = bb.from_monty(nttm.coset_lde(bb.to_monty(t), 1, bb.GENERATOR,
                                            out_bitrev=True))
        d = keccak.keccak256_words(rows)
        while d.shape[0] > 1:
            d = keccak.keccak256_words(np.concatenate([d[0::2], d[1::2]],
                                                      axis=1))
        roots.append(d[0])
    terms = bb.mul(q, counts[..., None]).astype(np.uint64)
    phi_last = terms.sum(axis=(1, 2)) % np.uint64(P)
    return np.stack(roots), phi_last.astype(np.uint32)


@pytest.mark.parametrize("world", [2, 4])
def test_logup_phi_step_matches_cumulative_sum(ranks, world):
    """Each rank's block of φ: its prefix sums plus the lower ranks'
    totals, against one cumulative sum mod p over the whole rows."""
    from valida_tpu.field import babybear as bb

    _traces, q, counts = _prove_inputs()
    terms = bb.mul(q, counts[..., None]).astype(np.uint64).sum(axis=2)
    want = (np.cumsum(terms, axis=1) % np.uint64(P)).astype(np.uint32)
    got = np.concatenate([r[("phi",)] for r in ranks(world)], axis=1)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dp,sp", PROVE_MESHES)
def test_sharded_prove_fn_matches_reference(ranks, dp, sp):
    want_roots, want_phi = reference_prove(*_prove_inputs())
    for roots, phi in (r[("prove", dp, sp)] for r in ranks(dp * sp)):
        assert np.array_equal(roots, want_roots)
        assert np.array_equal(phi, want_phi)


@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_multichip_matches_reference(ranks, world):
    """The dry run's shapes: 64 rows, below dist_dif's bounds, so the
    commit gathers the rows and extends them on every rank."""
    dp = 2
    rng = np.random.default_rng(0)
    traces = rng.integers(0, P, size=(dp, 64, 8), dtype=np.uint32)
    q = rng.integers(0, P, size=(dp, 64, 2, 5), dtype=np.uint32)
    counts = rng.integers(0, 2, size=(dp, 64, 2), dtype=np.uint32)
    want_roots, want_phi = reference_prove(traces, q, counts)
    for roots, phi in (r[("dryrun",)] for r in ranks(world)):
        assert np.array_equal(roots, want_roots)
        assert np.array_equal(phi, want_phi)


@pytest.mark.parametrize("world", [2, 4])
def test_dist_dif_applies_edges(ranks, world):
    """From 2^(7 + log2 D) rows on a D-rank axis; the dp axis has one
    rank, so from 128 rows; an axis the mesh lacks never."""
    log_d = world.bit_length() - 1
    want = {(log_h, axis): (axis == "sp" and log_h >= 7 + log_d)
            or (axis == "dp" and log_h >= 7)
            for log_h in range(5, 11) for axis in ("sp", "dp", "tp")}
    for r in ranks(world):
        assert r[("applies",)] == want
    assert not dist_ntt.dist_dif_applies(10, None)


def test_make_mesh_and_logup_errors(ranks):
    errors = ranks(2)[0][("mesh errors",)]
    assert "make_mesh(3): the process group has 2 ranks" in errors[(3, 1)]
    assert "does not divide" in errors[(2, 3)]
    assert "does not divide" in errors[(2, 0)]
    # the reference's halving loop drops a column at K = 3: refused
    assert "not a power of two" in errors["K = 3"]


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialised"):
        pmesh.make_mesh(2, device="cpu")
