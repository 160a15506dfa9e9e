"""Machine prover — the full multi-chip STARK pipeline.

Counterpart of valida_tpu/machine/prover.py.  Transcript order mirrors the
Rust prover generated by the `derive` crate:
  commit preprocessed -> commit main -> 3 permutation challenges ->
  commit permutation -> alpha -> commit quotient chunks -> zeta ->
  batch openings (FRI).

As in the JAX package, preprocessed traces are included in the openings,
so chips may reference preprocessed columns in constraints and
interactions.  Main traces are built on the PCS's device (from uploaded op
arrays, or uploaded once where a chip makes its trace on the host) and
stay there through the permutation traces, the quotient and
the commits; the Fiat–Shamir transcript runs on the host.
"""

from __future__ import annotations

import numpy as np

from ..air.check import check_constraints, check_cumulative_sums
from ..air.lookup import (
    cumulative_sum as perm_cumulative_sum,
    flatten_perm_trace,
    generate_permutation_trace,
)
from ..air.quotient import (
    decompose_and_flatten,
    get_log_quotient_degree,
    quotient_values,
)
from ..chips.chip import trace_on
from ..core.proof import ChipProof, Commitments, MachineProof, OpenedValues
from ..field import babybear as bb
from ..field import ext as extf
from ..utils import stage


def prove(machine, config) -> MachineProof:
    chips = machine.chips()
    pcs = config.pcs
    dev = pcs.device
    challenger = config.challenger()

    log_quotient_degrees = [get_log_quotient_degree(machine, c) for c in chips]

    # -- preprocessed commit ------------------------------------------------
    prep_traces = [c.preprocessed_trace() for c in chips]
    prep_indices = {}
    prep_list = []
    for ci, p in enumerate(prep_traces):
        if p is not None:
            prep_indices[ci] = len(prep_list)
            prep_list.append(np.asarray(p, dtype=np.uint32))
    if prep_list:
        with stage("commit to preprocessed traces"):
            prep_commit, prep_data = pcs.commit_batches(prep_list)
    else:
        prep_commit, prep_data = np.zeros(8, dtype=np.uint32), None
    challenger.observe_digest(prep_commit)

    # -- main traces: a chip with a builder uploads its op arrays and builds
    # its trace on the device; the others make theirs on the host and
    # upload it once
    with stage("generate main traces"):
        main_traces = [trace_on(c, machine, dev) for c in chips]
    log_degrees = [int(t.shape[0]).bit_length() - 1 for t in main_traces]
    g_subgroups = [bb.two_adic_generator(ld) for ld in log_degrees]
    for ci, p in enumerate(prep_traces):
        if p is not None:
            assert p.shape[0] == main_traces[ci].shape[0], (
                f"chip {chips[ci].name}: preprocessed height {p.shape[0]} != "
                f"main height {main_traces[ci].shape[0]}"
            )

    with stage("commit to main traces"):
        main_commit, main_data = pcs.commit_batches(main_traces)
    challenger.observe_digest(main_commit)

    # -- permutation --------------------------------------------------------
    perm_challenges = [challenger.sample_ext() for _ in range(3)]
    with stage("generate permutation traces"):
        perm_traces = [
            generate_permutation_trace(machine, c, t, perm_challenges)
            for c, t in zip(chips, main_traces)
        ]
    cumulative_sums = [perm_cumulative_sum(t) for t in perm_traces]
    perm_flat = [flatten_perm_trace(t) for t in perm_traces]
    with stage("commit to permutation traces"):
        perm_commit, perm_data = pcs.commit_batches(perm_flat)
    challenger.observe_digest(perm_commit)

    alpha = challenger.sample_ext()

    # -- debug checks (the framework's race detector) -----------------------
    if config.debug_checks:
        with stage("check constraints"):
            for c, t, pt, cs in zip(chips, main_traces, perm_traces,
                                    cumulative_sums):
                check_constraints(machine, c, t, pt, perm_challenges, cs)
            check_cumulative_sums(cumulative_sums)

    # -- quotient -----------------------------------------------------------
    quotient_mats = []
    coset_shifts = []
    with stage("compute quotient polynomial"):
        main_ldes = pcs.get_ldes(main_data)
        perm_ldes = pcs.get_ldes(perm_data)
        prep_ldes = pcs.get_ldes(prep_data) if prep_data is not None else []
        for ci, chip in enumerate(chips):
            qd = log_quotient_degrees[ci]
            prep_lde = (
                prep_ldes[prep_indices[ci]] if ci in prep_indices else None
            )
            qv = quotient_values(
                machine, chip, log_degrees[ci], qd,
                prep_lde, main_ldes[ci], perm_ldes[ci],
                cumulative_sums[ci], perm_challenges, alpha,
                pcs.coset_shift(), pcs.log_blowup,
            )
            quotient_mats.append(
                decompose_and_flatten(qv, pcs.coset_shift(), qd)
            )
            coset_shifts.append(bb.h_exp(pcs.coset_shift(), 1 << qd))
        del main_ldes, perm_ldes, prep_ldes

    with stage("commit to quotient chunks"):
        quotient_commit, quotient_data = pcs.commit_batches(
            quotient_mats, domain_shifts=coset_shifts
        )
    challenger.observe_digest(quotient_commit)

    # -- openings -----------------------------------------------------------
    zeta = challenger.sample_ext()
    zeta_next = [
        extf.e_mul(zeta, extf.e_from_base(g)) for g in g_subgroups
    ]
    main_points = [[zeta, zn] for zn in zeta_next]
    prep_points = [
        [zeta, zeta_next[ci]] for ci in sorted(prep_indices.keys())
    ]
    quotient_points = [
        [extf.e_exp(zeta, 1 << qd)] for qd in log_quotient_degrees
    ]

    rounds = []
    round_tags = []
    if prep_data is not None:
        rounds.append((prep_data, prep_points))
        round_tags.append("prep")
    rounds.append((main_data, main_points))
    round_tags.append("main")
    rounds.append((perm_data, main_points))
    round_tags.append("perm")
    rounds.append((quotient_data, quotient_points))
    round_tags.append("quotient")

    with stage("open multi batches"):
        opened_values, opening_proof = pcs.open_multi_batches(rounds,
                                                              challenger)
    opened = dict(zip(round_tags, opened_values))

    chip_proofs = []
    for ci, chip in enumerate(chips):
        if ci in prep_indices:
            pv = opened["prep"][prep_indices[ci]]
            prep_local, prep_next = pv[0], pv[1]
        else:
            prep_local, prep_next = [], []
        mv = opened["main"][ci]
        ev = opened["perm"][ci]
        qv = opened["quotient"][ci]
        chip_proofs.append(
            ChipProof(
                log_degree=log_degrees[ci],
                opened_values=OpenedValues(
                    preprocessed_local=prep_local,
                    preprocessed_next=prep_next,
                    trace_local=mv[0],
                    trace_next=mv[1],
                    permutation_local=ev[0],
                    permutation_next=ev[1],
                    quotient_chunks=qv[0],
                ),
                cumulative_sum=cumulative_sums[ci],
            )
        )

    return MachineProof(
        commitments=Commitments(
            preprocessed=np.asarray(prep_commit),
            main_trace=np.asarray(main_commit),
            perm_trace=np.asarray(perm_commit),
            quotient_chunks=np.asarray(quotient_commit),
        ),
        opening_proof=opening_proof,
        chip_proofs=chip_proofs,
    )
