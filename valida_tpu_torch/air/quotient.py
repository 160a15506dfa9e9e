"""Quotient polynomial evaluation and chunk decomposition.

Counterpart of valida_tpu/air/quotient.py (the Rust machine crate's
quotient.rs): the whole quotient domain (or one row tile after another,
`chunk`) is evaluated as tensor operations on the prover's device.  Every
constraint is a vector expression over [Q] Montgomery tensors, `next` rows
are wraparound rolls, and the zerofier inverse is a closed-form periodic
vector.
"""

from __future__ import annotations

import functools

import torch

from ..convert import table
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


@functools.lru_cache(maxsize=None)
def _zerofier_periods(log_degree: int, qd: int, shift: int):
    """(Z_H, 1/Z_H) over one period of the quotient coset, Montgomery."""
    zc = ZerofierOnCoset(log_degree, qd, shift)
    return zc._z_period, zc._zinv_period


def _ext_value(e, dev) -> VVal:
    """A host ext tuple, or a canonical int32 [5] tensor, as an ext VVal."""
    if isinstance(e, torch.Tensor):
        return VVal(bb.to_monty(e), True)
    return VVal(extf.ext_const(tuple(e), dev), True)


def quotient_values(machine, chip, log_degree, log_quotient_degree,
                    prep_lde, main_lde, perm_lde, cumulative_sum,
                    perm_challenges, alpha, pcs_shift, log_blowup,
                    chunk=0):
    """Evaluate the folded constraint polynomial / Z_H on the quotient
    domain (natural order).  LDE inputs are Montgomery int32 tensors in
    natural order, height N·2^log_blowup.  Returns the ext tensor
    [N·2^qd, 5] Montgomery.

    perm_challenges, alpha and cumulative_sum are host ext tuples, or
    canonical int32 tensors ([3, 5], [5], [5]): a staged prover passes
    tensors, so that its captured stage reads them rather than baking them
    in.  chunk (a power of two): evaluate the
    constraints over row tiles of that many rows, which bounds the
    temporaries at [chunk, 5] and multiplies the launches by the tile
    count; 0 evaluates the whole domain at once.  The words are the same
    either way (every expression is row-wise; the rolls are taken over the
    whole domain first)."""
    qd = log_quotient_degree
    stride = 1 << (log_blowup - qd)

    def local_next(lde):
        if lde is None:
            return None
        a = lde[::stride]
        return a, torch.roll(a, -(1 << qd), dims=0)

    return quotient_rows(machine, chip, log_degree, qd, local_next(prep_lde),
                         local_next(main_lde), local_next(perm_lde),
                         cumulative_sum, perm_challenges, alpha, pcs_shift,
                         chunk=chunk)


def quotient_rows(machine, chip, log_degree, log_quotient_degree, prep,
                  main, perm, cumulative_sum, perm_challenges, alpha,
                  pcs_shift, row0=0, chunk=0):
    """`quotient_values` on the rows [row0, row0 + R) of the quotient
    domain (row0 a multiple of 2^qd): prep, main and perm are pairs (the
    rows, each row's successor 2^qd rows on), Montgomery [R, w] tensors
    (prep None for a chip without one).  Returns [R, 5] Montgomery."""
    qd = log_quotient_degree
    dev = main[0].device
    q_size = int(main[0].shape[0])

    # the [R] selector vectors, built on the device (the JAX package's
    # device branch; its host branch gives the same words)
    sub_last = bb.monty_scalar(bb.h_inv(bb.two_adic_generator(log_degree)))
    xs = coset_points_device(log_degree + qd, pcs_shift, dev, row0, q_size)
    z_period, zinv_period = table(_zerofier_periods, log_degree, qd,
                                  pcs_shift % bb.P, device=dev)
    z_full = z_period.repeat(q_size >> qd)
    zinv = zinv_period.repeat(q_size >> qd)
    first_v = bb.mul(z_full, bb.inv_batch(bb.sub(xs, bb.monty_scalar(1))))
    last_v = bb.mul(z_full, bb.inv_batch(bb.sub(xs, sub_last)))
    trans_v = bb.sub(xs, sub_last)

    challenges = [_ext_value(perm_challenges[i], dev) for i in range(3)]
    alpha_v = _ext_value(alpha, dev)
    n_perm_ext = perm[0].shape[1] // 5
    prep = prep or (None, None)
    whole = dict(m_l=main[0], m_n=main[1], p_l=prep[0], p_n=prep[1],
                 e_l=perm[0], e_n=perm[1], tr=trans_v, fi=first_v,
                 la=last_v, zi=zinv)

    def eval_rows(o):
        """Fold all constraints over one row block (any length)."""
        builder = VectorBuilder(
            machine,
            main_local=_base_cols(o["m_l"]),
            main_next=_base_cols(o["m_n"]),
            prep_local=_base_cols(o["p_l"]) if prep[0] is not None else [],
            prep_next=_base_cols(o["p_n"]) if prep[0] is not None else [],
            perm_local=_ext_cols(o["e_l"], n_perm_ext),
            perm_next=_ext_cols(o["e_n"], n_perm_ext),
            perm_challenges=challenges,
            is_first_row=VVal(o["fi"], False),
            is_last_row=VVal(o["la"], False),
            is_transition=VVal(o["tr"], False),
            alpha=alpha_v,
            trace_height=1 << log_degree,
        )
        chip.eval(builder)
        eval_permutation_constraints(chip, builder, cumulative_sum)
        acc = builder.fold()
        if acc is None:
            return torch.zeros((o["m_l"].shape[0], 5), dtype=torch.int32,
                               device=dev)
        return extf.ext_mul_base(acc._as_ext(), o["zi"])

    if chunk and q_size > chunk:
        return torch.cat([
            eval_rows({k: (v[r0:r0 + chunk] if v is not None else None)
                       for k, v in whole.items()})
            for r0 in range(0, q_size, chunk)], dim=0)
    return eval_rows(whole)


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
