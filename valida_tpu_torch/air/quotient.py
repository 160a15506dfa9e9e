"""Quotient polynomial evaluation and chunk decomposition.

Counterpart of valida_tpu/air/quotient.py (the Rust machine crate's
quotient.rs).  On the card one launch of csrc/constraint.cu evaluates a
chip's whole constraint program (air/program.py) per row, reading the LDEs
in place; on the CPU the whole quotient domain is evaluated as tensor
operations (`quotient_rows_plain`, the kernel's plain version): every
constraint is a vector expression over [Q] Montgomery tensors and `next`
rows are gathered rows.  The selectors and the zerofier inverse are
closed-form vectors, built once per shape for the kernel
(`selector_tables`, dropped with the staged prover's graphs).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..convert import from_reference, table
from ..field import babybear as bb
from ..field import ext as extf
from ..poly import ntt as nttm
from ..poly.domain import ZerofierOnCoset, coset_points_device
from .builder import PlainVVal, SymbolicBuilder, VectorBuilder
from .lookup import eval_permutation_constraints
from .program import chip_program


def get_log_quotient_degree(machine, chip) -> int:
    """ceil(log2(max(deg, 3) - 1)) — `symbolic_builder.rs:17-30`."""
    b = SymbolicBuilder(machine, chip)
    chip.eval(b)
    deg = max(b.max_degree, 3)
    return max((deg - 2).bit_length(), 0) if deg > 1 else 0


def _base_cols(mat):
    return [PlainVVal(mat[:, c], False) for c in range(mat.shape[1])]


def _ext_cols(mat_m, n_ext):
    """[Q, n_ext*5] base Montgomery -> n_ext ext values [Q, 5]."""
    return [PlainVVal(mat_m[:, i * 5:(i + 1) * 5], True)
            for i in range(n_ext)]


@functools.lru_cache(maxsize=None)
def _zerofier_periods(log_degree: int, qd: int, shift: int):
    """(Z_H, 1/Z_H) over one period of the quotient coset, Montgomery."""
    zc = ZerofierOnCoset(log_degree, qd, shift)
    return zc._z_period, zc._zinv_period


def _ext_value(e, dev) -> PlainVVal:
    """A host ext tuple, or a canonical int32 [5] tensor, as an ext
    value."""
    if isinstance(e, torch.Tensor):
        return PlainVVal(bb.to_monty_plain(e), True)
    return PlainVVal(extf.ext_const(tuple(e), dev), True)


def quotient_values(machine, chip, log_degree, log_quotient_degree,
                    prep_lde, main_lde, perm_lde, cumulative_sum,
                    perm_challenges, alpha, pcs_shift, log_blowup):
    """Evaluate the folded constraint polynomial / Z_H on the quotient
    domain (natural order).  LDE inputs are Montgomery int32 tensors in
    natural order, height N·2^log_blowup.  Returns the ext tensor
    [N·2^qd, 5] Montgomery.

    perm_challenges, alpha and cumulative_sum are host ext tuples, or
    canonical int32 tensors ([3, 5], [5], [5]): a staged prover passes
    tensors, so that its captured stage reads them rather than baking them
    in."""
    qd = log_quotient_degree
    return quotient_rows(machine, chip, log_degree, qd, prep_lde, main_lde,
                         perm_lde, cumulative_sum, perm_challenges, alpha,
                         pcs_shift, stride=1 << (log_blowup - qd))


def quotient_rows(machine, chip, log_degree, log_quotient_degree, prep,
                  main, perm, cumulative_sum, perm_challenges, alpha,
                  pcs_shift, row0=0, *, rows=None, stride=1, bitrev=False):
    """`quotient_values` on the rows [row0, row0 + R) of the quotient
    domain (row0 a multiple of 2^qd), read from buffers: prep, main and
    perm are Montgomery [L, w] tensors (prep None for a chip without one)
    whose logical row j is row j·stride, bit-reversed over log2(L) bits
    if `bitrev`.  Quotient row i reads logical rows i and (i + 2^qd) mod
    (L / stride); R = `rows`, by default L / stride.  So a natural-order
    LDE passes its stride, the staged prover its bit-reversed LDE as it is,
    and a mesh rank its block of R rows followed by 2^qd halo rows.
    Returns [R, 5] Montgomery.

    On CUDA tensors one launch of csrc/constraint.cu (`constraint_eval`)
    evaluates every row; on CPU tensors `quotient_rows_plain` does.
    Nothing falls back: a launch that fails or a program that does not fit
    raises."""
    if _plain_side(main):
        return quotient_rows_plain(
            machine, chip, log_degree, log_quotient_degree, prep, main, perm,
            cumulative_sum, perm_challenges, alpha, pcs_shift, row0,
            rows=rows, stride=stride, bitrev=bitrev)
    return _quotient_rows_kernel(
        machine, chip, log_degree, log_quotient_degree, prep, main, perm,
        cumulative_sum, perm_challenges, alpha, pcs_shift, row0, rows,
        stride, bitrev)


def _plain_side(main) -> bool:
    """True when the buffers lie on the CPU."""
    return main.device.type == "cpu"


def _windows(buf, rows, stride, bitrev, qd):
    """(the rows, each row's successor 2^qd logical rows on) of a buffer,
    as the kernel reads them."""
    if buf is None:
        return None
    if bitrev:
        buf = nttm._gather_bitrev(buf, int(buf.shape[0]).bit_length() - 1)
    a = buf[::stride]
    h = 1 << qd
    if rows + h <= int(a.shape[0]):
        return a[:rows], a[h:h + rows]
    return a[:rows], torch.roll(a, -h, dims=0)[:rows]


def _selector_vectors(log_degree, qd, pcs_shift, dev, row0, q_size,
                      plain=False):
    """The [R] vectors is_first_row, is_last_row and is_transition over
    the rows [row0, row0 + R), built on the device (the JAX package's
    device branch; its host branch gives the same words), and 1/Z_H over
    one period of 2^qd rows; with `plain`, by the `*_plain` field
    functions."""
    mul, sub, inv_batch = ((bb.mul_plain, bb.sub_plain, bb.inv_batch_plain)
                           if plain else (bb.mul, bb.sub, bb.inv_batch))
    sub_last = bb.monty_scalar(bb.h_inv(bb.two_adic_generator(log_degree)))
    xs = coset_points_device(log_degree + qd, pcs_shift, dev, row0, q_size,
                             mul=mul)
    z_period, zinv_period = table(_zerofier_periods, log_degree, qd,
                                  pcs_shift % bb.P, device=dev)
    z_full = z_period.repeat(q_size >> qd)
    first_v = mul(z_full, inv_batch(sub(xs, bb.monty_scalar(1))))
    last_v = mul(z_full, inv_batch(sub(xs, sub_last)))
    trans_v = sub(xs, sub_last)
    return first_v, last_v, trans_v, zinv_period


# (log_degree, qd, shift, row0, rows, device) -> selector_tables' tables
_SELECTORS: dict = {}


def release_selector_tables() -> None:
    """Drop every selector table (machine/jit_prover.py `release_graphs`
    calls it with the graphs that read them)."""
    _SELECTORS.clear()


def selector_tables(log_degree, qd, pcs_shift, row0, rows, device):
    """`_selector_vectors` as device tables, built once per shape (3·R + 2^qd
    words): sel [3, R] (first, last, transition) and 1/Z_H's period.  Built
    by the first call, never inside a graph capture; kept until
    `release_selector_tables`."""
    key = (log_degree, qd, pcs_shift % bb.P, row0, rows, str(device))
    t = _SELECTORS.get(key)
    if t is None:
        if (torch.device(device).type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError("the quotient's selector tables are built "
                               "inside a captured stage (build them in its "
                               "eager first run)")
        first, last, trans, zinv = _selector_vectors(
            log_degree, qd, pcs_shift, torch.device(device), row0, rows)
        t = _SELECTORS[key] = (torch.stack([first, last, trans]), zinv)
    return t


def quotient_rows_plain(machine, chip, log_degree, log_quotient_degree,
                        prep, main, perm, cumulative_sum, perm_challenges,
                        alpha, pcs_shift, row0=0, *, rows=None, stride=1,
                        bitrev=False):
    """`quotient_rows` as tensor operations (VectorBuilder) on any device:
    the kernel's plain version.  Every constraint is a vector expression
    over [R] Montgomery tensors, the successors are gathered rows, and
    the constraints are folded with `VectorBuilder.fold`.  It computes
    with the `*_plain` field functions (`PlainVVal`), the selectors
    included, so that on the card it shares no CUDA code with the kernel
    (csrc/field.cuh's arithmetic among it)."""
    qd = log_quotient_degree
    n_rows = int(main.shape[0]) // stride if rows is None else rows
    prep, main, perm = (_windows(b, n_rows, stride, bitrev, qd)
                        for b in (prep, main, perm))
    dev = main[0].device
    q_size = int(main[0].shape[0])
    first_v, last_v, trans_v, zinv_period = _selector_vectors(
        log_degree, qd, pcs_shift, dev, row0, q_size, plain=True)
    zinv = zinv_period.repeat(q_size >> qd)
    builder = VectorBuilder(
        machine,
        main_local=_base_cols(main[0]),
        main_next=_base_cols(main[1]),
        prep_local=_base_cols(prep[0]) if prep is not None else [],
        prep_next=_base_cols(prep[1]) if prep is not None else [],
        perm_local=_ext_cols(perm[0], perm[0].shape[1] // 5),
        perm_next=_ext_cols(perm[1], perm[1].shape[1] // 5),
        perm_challenges=[_ext_value(perm_challenges[i], dev)
                         for i in range(3)],
        is_first_row=PlainVVal(first_v, False),
        is_last_row=PlainVVal(last_v, False),
        is_transition=PlainVVal(trans_v, False),
        alpha=_ext_value(alpha, dev),
        trace_height=1 << log_degree,
    )
    chip.eval(builder)
    eval_permutation_constraints(chip, builder,
                                 _ext_value(cumulative_sum, dev))
    acc = builder.fold()
    if acc is None:
        return torch.zeros((q_size, 5), dtype=torch.int32, device=dev)
    return bb.mul_plain(acc._as_ext(), zinv[:, None])


_PARAMS = ctypes.c_int64 * 12  # csrc/constraint.cuh `Param`


def _device_words(x, shape, dev) -> torch.Tensor:
    """A host ext tuple (or tuples) or a canonical int32 tensor as a
    contiguous int32 tensor of `shape` on dev."""
    if not isinstance(x, torch.Tensor):
        x = from_reference(np.array(x, dtype=np.uint32).reshape(shape), dev)
    if x.dtype != torch.int32 or x.device != dev or tuple(x.shape) != shape:
        raise ValueError(f"constraint_eval: expected an int32 {shape} tensor "
                         f"on {dev}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return x.contiguous()


def _quotient_rows_kernel(machine, chip, log_degree, qd, prep, main, perm,
                          cumulative_sum, perm_challenges, alpha, pcs_shift,
                          row0, rows, stride, bitrev):
    """One launch of constraint_eval over the rows (see quotient_rows)."""
    dev = main.device
    prog = chip_program(machine, chip, log_degree)
    w_main, w_prep, n_perm = prog.widths
    length = int(main.shape[0])
    for what, t, w in (("main", main, w_main), ("prep", prep, w_prep),
                       ("perm", perm, 5 * n_perm)):
        if t is None and what == "prep" and not w:
            continue
        if (t is None or t.dtype != torch.int32 or t.device != dev
                or not t.is_contiguous() or tuple(t.shape) != (length, w)):
            raise ValueError(
                f"constraint_eval {chip.name}: {what} must be a contiguous "
                f"int32 [{length}, {w}] tensor on {dev}, got "
                + ("None" if t is None else
                   f"{t.dtype} {tuple(t.shape)} on {t.device}"))
    lq = length // stride
    rows = lq if rows is None else rows
    if bitrev and length & (length - 1):
        raise ValueError(f"constraint_eval: a bit-reversed buffer of "
                         f"{length} rows")
    sel, zinv = selector_tables(log_degree, qd, pcs_shift, row0, rows, dev)
    ch = _device_words(perm_challenges, (3, 5), dev)
    al = _device_words(alpha, (5,), dev)
    cs = _device_words(cumulative_sum, (5,), dev)
    params = _PARAMS(rows, lq, stride,
                     length.bit_length() - 1 if bitrev else -1, qd, w_main,
                     w_prep, 5 * n_perm, prog.n_uniform, prog.n_row,
                     prog.uni_words, prog.slot_words)
    out = torch.empty((rows, 5), dtype=torch.int32, device=dev)
    _build.launch("constraint", "constraint_eval_launch", prog.on(dev), main,
                  prep, perm, sel, zinv, ch, al, cs, out, params)
    _build.count_launch("constraint_eval")
    return out


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
