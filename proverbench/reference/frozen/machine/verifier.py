"""Machine verifier — transcript replay, FRI verification, out-of-domain
constraint checking, and global bus balance.

Counterpart of valida_tpu/machine/verifier.py (the Rust verifier generated
by the `derive` crate and `verify_constraints` of machine/src/verify.rs),
with preprocessed openings included (see prover.py).  It runs on the host;
only the re-commit of the preprocessed traces runs on the PCS's device.
"""

from __future__ import annotations

import numpy as np

from ..air.builder import ScalarBuilder, SVal
from ..air.lookup import eval_permutation_constraints
from ..air.quotient import get_log_quotient_degree
from ..commit.fri import FriError
from ..core.proof import MachineProof
from ..field import babybear as bb
from ..field import ext as extf


class VerificationError(Exception):
    """Base verification failure (the Rust machine crate's error
    taxonomy, machine/src/error.rs)."""


class ProofShapeError(VerificationError):
    """Structurally malformed proof: wrong list lengths / widths / chip
    count (Rust `ProofShapeError`/`InvalidProofShape`)."""


class InvalidOpeningArgument(VerificationError):
    """The PCS/FRI opening proof failed (Rust `InvalidOpeningArgument`)."""


class OodEvaluationMismatch(VerificationError):
    """constraints(zeta) != Z_H(zeta)*quotient(zeta) (Rust
    `OodEvaluationMismatch`)."""


class NonZeroCumulativeSum(VerificationError):
    """Global bus imbalance (the sum of the cumulative sums is not 0)."""


def verify(machine, config, proof: MachineProof) -> None:
    """Verify `proof`.  Raises a `VerificationError` subclass on any
    failure; a structurally malformed proof raises `ProofShapeError` (the
    final except clause makes shape-induced crashes anywhere in the
    pipeline surface as the typed error, as the Rust verifier's
    Result-based taxonomy does rather than a panic)."""
    try:
        _verify_inner(machine, config, proof)
    except VerificationError:
        raise
    except (IndexError, ValueError, TypeError, KeyError, AttributeError) as e:
        raise ProofShapeError(f"malformed proof: {type(e).__name__}: {e}") \
            from e


def _verify_inner(machine, config, proof: MachineProof) -> None:
    chips = machine.chips()
    pcs = config.pcs
    challenger = config.challenger()

    if len(proof.chip_proofs) != len(chips):
        raise ProofShapeError("chip count mismatch")
    for cp in proof.chip_proofs:
        if not (0 <= int(cp.log_degree) <= 27):
            raise ProofShapeError("log_degree out of range")
        if len(tuple(cp.cumulative_sum)) != 5:
            raise ProofShapeError("cumulative sum is not an ext element")

    log_quotient_degrees = [get_log_quotient_degree(machine, c) for c in chips]
    log_degrees = [cp.log_degree for cp in proof.chip_proofs]
    g_subgroups = [bb.two_adic_generator(ld) for ld in log_degrees]

    # -- recompute preprocessed commitment (binding) ------------------------
    prep_traces = [c.preprocessed_trace() for c in chips]
    prep_indices = {}
    prep_list = []
    for ci, p in enumerate(prep_traces):
        if p is not None:
            prep_indices[ci] = len(prep_list)
            prep_list.append(np.asarray(p, dtype=np.uint32))
    if prep_list:
        prep_commit, _ = pcs.commit_batches(prep_list)
        if not np.array_equal(np.asarray(prep_commit),
                              np.asarray(proof.commitments.preprocessed)):
            raise VerificationError("preprocessed commitment mismatch")

    # -- transcript replay --------------------------------------------------
    challenger.observe_digest(proof.commitments.preprocessed)
    challenger.observe_digest(proof.commitments.main_trace)
    perm_challenges = [challenger.sample_ext() for _ in range(3)]
    challenger.observe_digest(proof.commitments.perm_trace)
    alpha = challenger.sample_ext()
    challenger.observe_digest(proof.commitments.quotient_chunks)
    zeta = challenger.sample_ext()

    # -- shape recomputation ------------------------------------------------
    main_dims = []
    perm_dims = []
    quotient_dims = []
    prep_dims = []
    for ci, (chip, cp) in enumerate(zip(chips, proof.chip_proofs)):
        h = 1 << cp.log_degree
        w = chip.width()
        n_int = len(chip.all_interactions(machine))
        main_dims.append((h, w))
        perm_dims.append((h, (n_int + 1) * 5))
        quotient_dims.append((h, (1 << log_quotient_degrees[ci]) * 5))
        if ci in prep_indices:
            p = prep_traces[ci]
            if p.shape[0] != h:
                raise ProofShapeError(
                    f"chip {chip.name}: preprocessed height mismatch"
                )
            prep_dims.append((h, int(p.shape[1])))
        ov = cp.opened_values
        expect = [
            (len(ov.trace_local), w),
            (len(ov.trace_next), w),
            (len(ov.permutation_local), (n_int + 1) * 5),
            (len(ov.permutation_next), (n_int + 1) * 5),
            (len(ov.quotient_chunks), (1 << log_quotient_degrees[ci]) * 5),
        ]
        if any(a != b for a, b in expect):
            raise ProofShapeError(f"chip {chip.name}: opened shape mismatch")

    zeta_next = [extf.e_mul(zeta, extf.e_from_base(g)) for g in g_subgroups]
    main_points = [[zeta, zn] for zn in zeta_next]
    prep_points = [[zeta, zeta_next[ci]] for ci in sorted(prep_indices.keys())]
    quotient_points = [
        [extf.e_exp(zeta, 1 << qd)] for qd in log_quotient_degrees
    ]

    # -- reassemble opened values in round order ---------------------------
    opened_prep = [None] * len(prep_list)
    for ci, pi in prep_indices.items():
        ov = proof.chip_proofs[ci].opened_values
        opened_prep[pi] = [ov.preprocessed_local, ov.preprocessed_next]
    opened_main = [
        [cp.opened_values.trace_local, cp.opened_values.trace_next]
        for cp in proof.chip_proofs
    ]
    opened_perm = [
        [cp.opened_values.permutation_local, cp.opened_values.permutation_next]
        for cp in proof.chip_proofs
    ]
    opened_quotient = [[cp.opened_values.quotient_chunks]
                       for cp in proof.chip_proofs]

    rounds = []
    dims = []
    opened_values = []
    if prep_list:
        rounds.append((proof.commitments.preprocessed, prep_points))
        dims.append(prep_dims)
        opened_values.append(opened_prep)
    rounds.append((proof.commitments.main_trace, main_points))
    dims.append(main_dims)
    opened_values.append(opened_main)
    rounds.append((proof.commitments.perm_trace, main_points))
    dims.append(perm_dims)
    opened_values.append(opened_perm)
    rounds.append((proof.commitments.quotient_chunks, quotient_points))
    dims.append(quotient_dims)
    opened_values.append(opened_quotient)

    try:
        pcs.verify_multi_batches(rounds, dims, opened_values,
                                 proof.opening_proof, challenger)
    except FriError as e:
        raise InvalidOpeningArgument(f"opening proof invalid: {e}") from e

    # -- out-of-domain constraint check per chip ----------------------------
    for ci, (chip, cp) in enumerate(zip(chips, proof.chip_proofs)):
        verify_constraints(
            machine, chip, cp.opened_values, cp.cumulative_sum,
            cp.log_degree, g_subgroups[ci], zeta, alpha, perm_challenges,
            log_quotient_degrees[ci],
        )

    # -- global bus balance -------------------------------------------------
    total = extf.E_ZERO
    for cp in proof.chip_proofs:
        total = extf.e_add(total, tuple(cp.cumulative_sum))
    if total != extf.E_ZERO:
        raise NonZeroCumulativeSum(
            "nonzero global cumulative sum (bus imbalance)")


def _unflatten(vals):
    """Group flat base-column openings into extension elements:
    e = sum_d vals[5k + d] * basis_d."""
    out = []
    for k in range(len(vals) // 5):
        acc = extf.E_ZERO
        for d in range(5):
            basis = tuple(1 if i == d else 0 for i in range(5))
            acc = extf.e_add(acc, extf.e_mul(tuple(vals[5 * k + d]), basis))
        out.append(acc)
    return out


def verify_constraints(machine, chip, opened_values, cumulative_sum,
                       log_degree, g, zeta, alpha, perm_challenges,
                       log_quotient_degree) -> None:
    """OOD fold check: constraints(zeta) == Z_H(zeta) * quotient(zeta)."""
    z_h = extf.e_sub(extf.e_exp(zeta, 1 << log_degree), extf.E_ONE)
    zeta_m1 = extf.e_sub(zeta, extf.E_ONE)
    g_inv = bb.h_inv(g)
    zeta_mg = extf.e_sub(zeta, extf.e_from_base(g_inv))
    is_first = extf.e_mul(z_h, extf.e_inv(zeta_m1))
    is_last = extf.e_mul(z_h, extf.e_inv(zeta_mg))
    is_transition = zeta_mg

    ov = opened_values
    builder = ScalarBuilder(
        machine,
        main_local=[SVal(tuple(v)) for v in ov.trace_local],
        main_next=[SVal(tuple(v)) for v in ov.trace_next],
        prep_local=[SVal(tuple(v)) for v in ov.preprocessed_local],
        prep_next=[SVal(tuple(v)) for v in ov.preprocessed_next],
        perm_local=[SVal(e) for e in _unflatten(ov.permutation_local)],
        perm_next=[SVal(e) for e in _unflatten(ov.permutation_next)],
        perm_challenges=[SVal(tuple(c)) for c in perm_challenges],
        is_first_row=SVal(is_first),
        is_last_row=SVal(is_last),
        is_transition=SVal(is_transition),
        alpha=SVal(tuple(alpha)),
        trace_height=1 << log_degree,
    )
    chip.eval(builder)
    eval_permutation_constraints(chip, builder, tuple(cumulative_sum))
    folded = builder.accumulator.e

    # recombine the quotient chunks, stored in bit-reversed order
    parts = _unflatten(ov.quotient_chunks)
    n_parts = len(parts)
    bits = n_parts.bit_length() - 1
    reordered = [None] * n_parts
    for i in range(n_parts):
        r = 0
        x = i
        for _ in range(bits):
            r = (r << 1) | (x & 1)
            x >>= 1
        reordered[r] = parts[i]
    quotient = extf.E_ZERO
    zp = extf.E_ONE
    for part in reordered:
        quotient = extf.e_add(quotient, extf.e_mul(zp, part))
        zp = extf.e_mul(zp, zeta)

    if folded != extf.e_mul(z_h, quotient):
        raise OodEvaluationMismatch(
            f"chip {chip.name}: OOD evaluation mismatch"
        )
