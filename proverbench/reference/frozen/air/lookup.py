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

import torch

from ..field import babybear as bb
from ..field import ext as extf
from .builder import SVal, SymExpr, VVal
from .types import SEND


def _alpha_counts(chip, machine):
    def max_bus(interactions):
        idxs = [i.bus.index for i in interactions]
        return (max(idxs) + 1) if idxs else 1

    return (
        max_bus(chip.local_sends() + chip.local_receives()),
        max_bus(chip.global_sends(machine) + chip.global_receives(machine)),
    )


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
    mode) a canonical int32 [5] tensor, or already a builder value (a
    program's input node, air/program.py)."""
    if hasattr(cs, "is_ext"):
        return cs
    if isinstance(builder.perm_challenges[0], SymExpr):
        return SymExpr(0)
    if isinstance(builder.perm_challenges[0], SVal):
        return SVal(tuple(cs))
    if isinstance(cs, torch.Tensor):
        return VVal(bb.to_monty(cs), True)
    return VVal(extf.ext_const(tuple(cs), builder.device), True)
