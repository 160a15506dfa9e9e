"""LogUp-style bus lookup engine.

Counterpart of valida_tpu/air/lookup.py (the Rust machine crate's
`generate_permutation_trace`, `eval_permutation_constraints` and
`generate_rlc_elements`):

* per interaction m, reciprocal column q_m(row) = 1/(alpha_bus + sum_j
  beta^j f_{m,j}(row));
* running-sum column phi accumulating +q*count for sends, -q*count for
  receives: an int64 `torch.cumsum` of the per-row terms, then one `% p`
  (every term is below p < 2^31, so the sum is exact below 2^32 rows);
* AIR side re-asserts the reciprocals and the telescoping sum; the machine
  verifier closes the argument with sum(cumulative_sums) == 0.

alpha_local[i] = ch0^{i+1}, alpha_global[i] = ch1^{i+1}, betas = ch2^j
(from j = 0), as `generate_rlc_elements`' `.powers().skip(1)`.

Traces are int32 tensors on the prover's device; the result stays there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import from_reference, to_numpy
from ..field import babybear as bb
from ..field import ext as extf
from .builder import SVal, SymExpr, VVal
from .types import SEND, RECEIVE


def _alpha_counts(chip, machine):
    def max_bus(interactions):
        idxs = [i.bus.index for i in interactions]
        return (max(idxs) + 1) if idxs else 1

    return (
        max_bus(chip.local_sends() + chip.local_receives()),
        max_bus(chip.global_sends(machine) + chip.global_receives(machine)),
    )


def rlc_alphas(chip, machine, challenges):
    """(alphas_local, alphas_global) keyed by bus index (host ext tuples)."""
    n_local, n_global = _alpha_counts(chip, machine)
    local = extf.e_powers(challenges[0], n_local + 1)[1:]
    glob = extf.e_powers(challenges[1], n_global + 1)[1:]
    return local, glob


def _apply_vpcol_device(vp, prep_m, main_m):
    n = main_m.shape[0]
    acc = torch.full((n,), bb.monty_scalar(vp.constant), dtype=torch.int32,
                     device=main_m.device)
    for (trace, idx), w in vp.weights:
        col = main_m[:, idx] if trace == "main" else prep_m[:, idx]
        if w == 1:
            acc = bb.add(acc, col)
        else:
            acc = bb.add(acc, bb.mul(col, bb.monty_scalar(w % bb.P)))
    return acc


def _interaction_rlc_device(interaction, betas_m, alpha_m, prep_m, main_m):
    """RLC over all rows: [N, 5] ext Montgomery."""
    n = main_m.shape[0]
    acc = torch.zeros((n, 5), dtype=torch.int32, device=main_m.device)
    for j, field in enumerate(interaction.fields):
        fvals = _apply_vpcol_device(field, prep_m, main_m)  # [N] base monty
        acc = bb.add(acc, bb.mul(fvals[:, None], betas_m[j][None, :]))
    return bb.add(acc, alpha_m[None, :])


def _ext_powers_arr(ch_m, count, skip_first=False):
    """Powers of a [5] Montgomery ext tensor: [ch^1..] if skip_first else
    [1, ch..]."""
    out = []
    acc = ch_m
    if not skip_first:
        out.append(extf.ext_one(ch_m.device))
        count -= 1
    for _ in range(count):
        out.append(acc)
        acc = extf.ext_mul(acc, ch_m)
    return out


def perm_cols_and_terms(machine, chip, main_m, prep_m, challenges):
    """Row-parallel part of the permutation trace: the reciprocal columns
    q_m and the per-row phi increments (sum of +-q*count).  main_m/prep_m
    are Montgomery tensors; challenges is a canonical [3, 5] tensor.
    Returns (cols list of [N, 5] monty, terms [N, 5] monty or None)."""
    interactions = chip.all_interactions(machine)
    ch_m = bb.to_monty(challenges)
    n_local, n_global = _alpha_counts(chip, machine)
    alphas_local = _ext_powers_arr(ch_m[0], n_local, skip_first=True)
    alphas_global = _ext_powers_arr(ch_m[1], n_global, skip_first=True)
    max_fields = max((len(i.fields) for i in interactions), default=1)
    betas = _ext_powers_arr(ch_m[2], max_fields)

    cols = []
    for inter in interactions:
        alpha = (
            alphas_local[inter.bus.index]
            if inter.bus.is_local
            else alphas_global[inter.bus.index]
        )
        rlc = _interaction_rlc_device(inter, betas, alpha, prep_m, main_m)
        cols.append(extf.ext_inv(rlc))  # q_m; ext_inv maps 0 -> 0

    terms = None
    for (inter, itype), q in zip(chip.typed_interactions(machine), cols):
        count = _apply_vpcol_device(inter.count, prep_m, main_m)
        t = extf.ext_mul_base(q, count)
        if itype == RECEIVE:
            t = bb.neg(t)
        terms = t if terms is None else bb.add(terms, t)
    return cols, terms


def padded_prep(chip, n: int, device, prep=None):
    """The chip's preprocessed trace (or `prep`, a canonical int32 tensor
    in its place) as a canonical int32 tensor of n rows (zero rows
    appended), or None."""
    if prep is None:
        prep = chip.preprocessed_trace()
        if prep is None:
            return None
        prep = from_reference(np.asarray(prep, dtype=np.uint32), device)
    if int(prep.shape[0]) < n:
        pad = prep.new_zeros((n - int(prep.shape[0]), int(prep.shape[1])))
        prep = torch.cat([prep, pad], dim=0)
    return prep[:n]


def phi_column(terms: torch.Tensor, carry=None) -> torch.Tensor:
    """Running sum of the [N, 5] Montgomery phi increments (plus `carry`,
    a [5] Montgomery value before the first row): an int64 prefix sum per
    coefficient (a scan over the rows of a [N, 5] array runs 5 serial
    lanes on the GPU) and one `% p`; every term is below p, so the sum is
    exact below 2^32 rows."""
    coeffs = terms.to(torch.int64).t().contiguous()
    phi = torch.stack([torch.cumsum(c, dim=0) for c in coeffs], dim=1)
    if carry is not None:
        phi = phi + carry.to(torch.int64)[None, :]
    return (phi % bb.P).to(torch.int32)


def generate_permutation_trace(machine, chip, main_trace, challenges,
                               prep=None):
    """main_trace: canonical int32 tensor [N, C]; challenges: 3 ext values
    as host tuples, or a canonical int32 [3, 5] tensor (a staged prover
    passes the tensor, so that its captured stage reads the challenges
    rather than baking them in).  prep: the chip's preprocessed trace as a
    canonical int32 tensor, or None to read `chip.preprocessed_trace()`
    (a staged prover passes it, for the same reason); zero-padded to N
    rows.

    Returns the permutation trace as an ext tensor [N, n_interactions + 1,
    5] Montgomery on main_trace's device, the last ext column the running
    sum phi.
    """
    dev = main_trace.device
    n = int(main_trace.shape[0])
    main_m = bb.to_monty(main_trace)
    prep = padded_prep(chip, n, dev, prep)
    prep_m = bb.to_monty(prep) if prep is not None else None
    if not isinstance(challenges, torch.Tensor):
        challenges = from_reference(np.array(challenges, dtype=np.uint32),
                                    dev)
    cols, terms = perm_cols_and_terms(machine, chip, main_m, prep_m,
                                      challenges)
    if not cols:
        return torch.zeros((n, 1, 5), dtype=torch.int32, device=dev)
    return torch.stack(cols + [phi_column(terms)], dim=1)


def cumulative_sum(perm_trace):
    """Last phi value as a host ext tuple (canonical)."""
    last = to_numpy(bb.from_monty(perm_trace[-1, -1]))
    return tuple(int(x) for x in last)


def flatten_perm_trace(perm_trace):
    """[N, K, 5] ext Montgomery -> [N, K*5] canonical tensor for
    committing."""
    n, k, d = perm_trace.shape
    return bb.from_monty(perm_trace).reshape(n, k * d)


def eval_permutation_constraints(chip, builder, cumulative_sum_value):
    """Builder-generic permutation AIR (the Rust machine crate's
    `eval_permutation_constraints`)."""
    machine = builder.machine
    interactions = list(chip.typed_interactions(machine))
    challenges = builder.perm_challenges
    alphas_local_n, alphas_global_n = _alpha_counts(chip, machine)

    # alpha powers as builder expressions: ch^(i+1)
    def powers_of(ch, count):
        out = []
        acc = ch
        for _ in range(count):
            out.append(acc)
            acc = acc * ch
        return out

    alphas_local = powers_of(challenges[0], alphas_local_n)
    alphas_global = powers_of(challenges[1], alphas_global_n)
    max_fields = max((len(i.fields) for i, _ in interactions), default=1)
    betas = [builder.const(1)]
    for _ in range(max_fields - 1):
        betas.append(betas[-1] * challenges[2])

    perm_local = builder.perm_local
    perm_next = builder.perm_next
    phi_local = perm_local[-1]
    phi_next = perm_next[-1]

    lhs = phi_next - phi_local
    rhs = builder.const(0)
    phi_0 = builder.const(0)

    for m, (inter, itype) in enumerate(interactions):
        rlc = builder.const(0)
        for j, field in enumerate(inter.fields):
            elem = field.apply(
                builder.preprocessed_local, builder.main_local, builder.const
            )
            rlc = rlc + betas[j] * elem
        alpha = (
            alphas_local[inter.bus.index]
            if inter.bus.is_local
            else alphas_global[inter.bus.index]
        )
        rlc = rlc + alpha
        builder.assert_one(rlc * perm_local[m])

        mult_local = inter.count.apply(
            builder.preprocessed_local, builder.main_local, builder.const
        )
        mult_next = inter.count.apply(
            builder.preprocessed_next, builder.main_next, builder.const
        )
        if itype == SEND:
            phi_0 = phi_0 + perm_local[m] * mult_local
            rhs = rhs + perm_next[m] * mult_next
        else:
            phi_0 = phi_0 - perm_local[m] * mult_local
            rhs = rhs - perm_next[m] * mult_next

    builder.when_transition().assert_eq(lhs, rhs)
    builder.when_first_row().assert_eq(phi_local, phi_0)
    builder.when_last_row().assert_eq(
        phi_local, _cum_sum_expr(builder, cumulative_sum_value)
    )


def _cum_sum_expr(builder, cs):
    """The cumulative sum as a builder value: a host ext tuple, or (vector
    mode) a canonical int32 [5] tensor."""
    if isinstance(builder.perm_challenges[0], SymExpr):
        return SymExpr(0)
    if isinstance(builder.perm_challenges[0], SVal):
        return SVal(tuple(cs))
    if isinstance(cs, torch.Tensor):
        return VVal(bb.to_monty(cs), True)
    return VVal(extf.ext_const(tuple(cs), builder.device), True)
