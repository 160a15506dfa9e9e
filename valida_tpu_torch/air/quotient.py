"""Quotient polynomial evaluation and chunk decomposition.

Counterpart of valida_tpu/air/quotient.py (the Rust machine crate's
quotient.rs): the whole quotient domain is evaluated at once as tensor
operations on the prover's device.  Every constraint is a vector
expression over [Q] Montgomery tensors, `next` rows are wraparound rolls,
and the zerofier inverse is a closed-form periodic vector.
"""

from __future__ import annotations

import torch

from ..convert import from_reference
from ..field import babybear as bb
from ..field import ext as extf
from ..poly import ntt as nttm
from ..poly.domain import ZerofierOnCoset, coset_points_device
from .builder import SymbolicBuilder, VectorBuilder, VVal
from .lookup import eval_permutation_constraints


def get_log_quotient_degree(machine, chip) -> int:
    """ceil(log2(max(deg, 3) - 1)) — `symbolic_builder.rs:17-30`."""
    b = SymbolicBuilder(machine, chip)
    chip.eval(b)
    deg = max(b.max_degree, 3)
    return max((deg - 2).bit_length(), 0) if deg > 1 else 0


def _base_cols(mat):
    return [VVal(mat[:, c], False) for c in range(mat.shape[1])]


def _ext_cols(mat_m, n_ext):
    """[Q, n_ext*5] base Montgomery -> n_ext ext VVals [Q, 5]."""
    return [VVal(mat_m[:, i * 5:(i + 1) * 5], True) for i in range(n_ext)]


def quotient_values(machine, chip, log_degree, log_quotient_degree,
                    prep_lde, main_lde, perm_lde, cumulative_sum,
                    perm_challenges, alpha, pcs_shift, log_blowup):
    """Evaluate the folded constraint polynomial / Z_H on the quotient
    domain (natural order).  LDE inputs are Montgomery int32 tensors in
    natural order, height N·2^log_blowup.  Returns the ext tensor
    [N·2^qd, 5] Montgomery."""
    qd = log_quotient_degree
    stride = 1 << (log_blowup - qd)
    next_step = 1 << qd

    main = main_lde[::stride]
    perm = perm_lde[::stride]
    prep = prep_lde[::stride] if prep_lde is not None else None
    dev = main.device

    def roll(a):
        return torch.roll(a, -next_step, dims=0)

    # the [Q] selector vectors, built on the device (the JAX package's
    # device branch; its host branch gives the same words)
    zc = ZerofierOnCoset(log_degree, qd, pcs_shift)
    sub_last = bb.monty_scalar(bb.h_inv(bb.two_adic_generator(log_degree)))
    xs = coset_points_device(log_degree + qd, pcs_shift, dev)
    z_full = from_reference(zc._z_period, dev).repeat(1 << log_degree)
    zinv = from_reference(zc._zinv_period, dev).repeat(1 << log_degree)
    first_v = bb.mul(z_full, bb.inv_batch(bb.sub(xs, bb.monty_scalar(1))))
    last_v = bb.mul(z_full, bb.inv_batch(bb.sub(xs, sub_last)))
    trans_v = bb.sub(xs, sub_last)

    def ext_const(e):
        return VVal(extf.ext_const(tuple(e), dev), True)

    n_perm_ext = perm.shape[1] // 5
    builder = VectorBuilder(
        machine,
        main_local=_base_cols(main),
        main_next=_base_cols(roll(main)),
        prep_local=_base_cols(prep) if prep is not None else [],
        prep_next=_base_cols(roll(prep)) if prep is not None else [],
        perm_local=_ext_cols(perm, n_perm_ext),
        perm_next=_ext_cols(roll(perm), n_perm_ext),
        perm_challenges=[ext_const(perm_challenges[i]) for i in range(3)],
        is_first_row=VVal(first_v, False),
        is_last_row=VVal(last_v, False),
        is_transition=VVal(trans_v, False),
        alpha=ext_const(alpha),
        trace_height=1 << log_degree,
    )
    chip.eval(builder)
    eval_permutation_constraints(chip, builder, cumulative_sum)
    acc = builder.fold()
    if acc is None:
        return torch.zeros((main.shape[0], 5), dtype=torch.int32, device=dev)
    return extf.ext_mul_base(acc._as_ext(), zinv)


def decompose_and_flatten(q_vals, pcs_shift, log_quotient_degree):
    """Quotient evals on coset shift·K (size N·2^qd, natural, ext
    Montgomery) -> chunk matrix [N, 2^qd * 5] canonical int32, chunks in
    bit-reversed order.

    Chunk_i holds coefficients j = i (mod 2^qd) of Q, evaluated on the
    coset shift^{2^qd}·H_N; the verifier recombines Q(z) = sum_i z^i *
    chunk_{rev(i)}(z^{2^qd}) (`machine/src/verify.rs:94-105`).
    """
    qd = log_quotient_degree
    q = q_vals.shape[0]
    n = q >> qd
    coeffs = nttm.coset_intt(q_vals, pcs_shift)  # [Q, 5]
    shift_chunk = bb.h_exp(pcs_shift, 1 << qd)
    rev = nttm.bitrev_indices(qd) if qd > 0 else [0]
    chunks = [
        bb.from_monty(nttm.coset_eval_from_coeffs(coeffs[int(i)::1 << qd],
                                                  shift_chunk))
        for i in rev
    ]
    return torch.cat(chunks, dim=1).reshape(n, (1 << qd) * 5)
