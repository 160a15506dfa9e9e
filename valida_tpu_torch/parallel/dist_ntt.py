"""The four-step NTT over a mesh axis, with explicit all-to-alls.

Counterpart of valida_tpu/parallel/dist_ntt.py.  Rows are sharded over
the D ranks of one mesh axis in contiguous blocks.  Viewing x as [128, M]
(M = N/128; row a of the view holds x[a·M : (a+1)·M]), each rank holds
128/D rows of the view, and

    dif(x)[a·M + v] = dif_M(w_N^(rev7(a)·t) · dif_128(x[:, t])[a])[v]

where dif_128 runs over the view's rows (bit-reversed out), rev7 reverses
7 bits and w_N is the order-N root (its inverse for the inverse
transform).  So `dist_dif` is:

  1. all_to_all: row slices -> column slices (each rank: all 128 rows
     for the t of its M/D columns);
  2. the 128-point `dif` over axis 0 of the [128, (M/D)·cols] array, then
     the twiddles w_N^(rev7(a)·t) for this rank's t;
  3. all_to_all: column slices -> block ranges (each rank: 128/D whole
     rows a of the view);
  4. one M-point `dif` of the 128/D blocks, riding the trailing axis.

The output is this rank's contiguous block of the bit-reversed `dif` of
the whole array, word for word.  Both local steps run `poly/ntt.dif`, so
on the card they run the NTT kernels (`ntt_dif_whole` where the width is
a multiple of 128, else `ntt_dif_ragged`); the TPU's [128, 128] modular
matrix product is not needed.

A row move (`move_rows`) sends each rank the rows it names of a
row-sharded array, in one all_to_all with uneven splits and host tables
of who sends what.  `dist_coeffs` (the inverse transform, coefficients
left bit-reversed by block) and `dist_extend` (the move into the
zero-padded natural order, then the forward transform) make the
distributed LDE; `dist_eval` evaluates such coefficients in natural
order.  The staged prover (machine/jit_prover.py) moves its quotient rows
with `move_rows` too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..convert import table
from ..field import babybear as bb
from ..poly import ntt as nttm

LOG_B = 7
B = 1 << LOG_B  # points of the distributed step


def axis_info(mesh, axis: str):
    """(size, this rank's index, process group) of mesh axis `axis`."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return (int(mesh.shape[names.index(axis)]), mesh.get_local_rank(axis),
            mesh.get_group(axis))


def dif_applies(log_h: int, d: int) -> bool:
    """Whether `dist_dif` takes a transform of 2^log_h rows over d ranks:
    a 128-point first step, whole column slices and whole blocks on every
    rank (valida_tpu/machine/jit_prover.py::_dist_dif_applies)."""
    return log_h >= LOG_B and B % d == 0 and ((1 << log_h) >> LOG_B) % d == 0


def dist_dif_applies(log_h: int, mesh, axis: str = "sp") -> bool:
    """`dif_applies` on the ranks of mesh axis `axis` (False without it)."""
    if mesh is None or axis not in tuple(mesh.mesh_dim_names or ()):
        return False
    return dif_applies(log_h, axis_info(mesh, axis)[0])


# collectives issued on the card or the host: "eager" ones, and "captured"
# into a CUDA graph (machine/jit_prover.py adds a graph's at each replay to
# "replayed")
COLLECTIVES = {"eager": 0, "captured": 0, "replayed": 0}


def count_collective() -> None:
    """Count one collective about to be issued (see COLLECTIVES)."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        COLLECTIVES["captured"] += 1
    else:
        COLLECTIVES["eager"] += 1


@functools.lru_cache(maxsize=None)
def _step_twiddles(log_n: int, inverse: bool, d: int, r: int) -> np.ndarray:
    """Montgomery [128, M/D] of rank r: row a, column t_l holds
    w^(rev7(a)·t), t = r·M/D + t_l, w the order-2^log_n root (its inverse
    for the inverse transform); valida_tpu/poly/mxu_ntt.py::_step_twiddles'
    table for this rank's t, transposed."""
    md = (1 << (log_n - LOG_B)) // d
    w = bb.two_adic_generator(log_n)
    if inverse:
        w = bb.h_inv(w)
    rows = []
    for u in nttm.bitrev_indices(LOG_B):
        wu = pow(w, int(u), bb.P)
        start = np.uint64(pow(wu, r * md, bb.P))
        rows.append(nttm._powers_host(wu, md).astype(np.uint64) * start
                    % np.uint64(bb.P))
    return ((np.stack(rows) << np.uint64(32)) % np.uint64(bb.P)).astype(
        np.uint32)


def dist_dif(a_local: torch.Tensor, mesh, axis: str = "sp",
             inverse: bool = False) -> torch.Tensor:
    """Natural-in, bitrev-out DIF over axis 0 of the row-sharded array
    whose block on this rank is a_local [N/D, ...] (Montgomery int32).
    Returns this rank's block of `ntt.dif` of the whole array.  Two
    all_to_alls on the axis's group."""
    d, r, group = axis_info(mesh, axis)
    n = int(a_local.shape[0]) * d
    log_n = n.bit_length() - 1
    m = n >> LOG_B
    if 1 << log_n != n or log_n < LOG_B or B % d or m % d:
        raise ValueError(f"dist_dif: {n} rows over {d} ranks (needs a "
                         f"power of two >= 128, D | 128 and D | N/128)")
    rest = tuple(a_local.shape[1:])
    cols = int(np.prod(rest, dtype=np.int64))
    md = m // d
    # 1. chunk j: this rank's rows of the view at rank j's columns
    x = a_local.reshape(B // d, d, md, cols).transpose(0, 1).contiguous()
    y = torch.empty_like(x)
    count_collective()
    dist.all_to_all_single(y, x, group=group)  # [D, 128/D, M/D, cols]
    # 2. the 128-point step and the twiddles of this rank's columns
    y = nttm.dif(y.reshape(B, md * cols), inverse)
    tw = table(_step_twiddles, log_n, inverse, d, r, device=a_local.device)
    y = bb.mul(y.reshape(B, md, cols), tw[:, :, None])
    # 3. chunk j: rank j's rows of the view at this rank's columns
    z = torch.empty_like(y)
    count_collective()
    dist.all_to_all_single(z, y, group=group)
    # z[i, a_l, t_l] is row a_l of this rank's blocks at column i·M/D + t_l
    z = z.reshape(d, B // d, md, cols).transpose(0, 1).reshape(B // d, m,
                                                               cols)
    # 4. the M-point transforms of the 128/D blocks, batched
    if m > 1:
        z = nttm.dif(z.transpose(0, 1).reshape(m, (B // d) * cols), inverse)
        z = z.reshape(m, B // d, cols).transpose(0, 1)
    return z.reshape((n // d,) + rest)


@functools.lru_cache(maxsize=None)
def row_moves(src_rows: int, want, args: tuple, d: int, r: int):
    """Rank r's part in a row move.  A source array of src_rows rows is
    sharded over d ranks in contiguous blocks; every rank q takes the rows
    want(d, q, *args) (global indices, an array) in that order, so a row
    may go to several ranks.  Returns (the local rows rank r sends, in the
    order sent; the rows sent to each rank; the rows received from each
    rank; the place in rank r's output of each received row, in arrival
    order; the output's rows)."""
    blk = src_rows // d
    wants = [np.asarray(want(d, q, *args), dtype=np.int64) for q in range(d)]
    sends = [w[w // blk == r] - r * blk for w in wants]
    owner = wants[r] // blk
    return (np.concatenate(sends), tuple(len(s) for s in sends),
            tuple(int(c) for c in np.bincount(owner, minlength=d)),
            np.argsort(owner, kind="stable"), len(owner))


def _move_tables(src_rows, want, args, d, r):
    """Device tables of `move_rows` (send order, places), u32."""
    send, _s, _r, place, _n = row_moves(src_rows, want, args, d, r)
    return send.astype(np.uint32), place.astype(np.uint32)


def move_rows(local: torch.Tensor, mesh, axis: str, want,
              args: tuple) -> torch.Tensor:
    """This rank's rows of the move `row_moves(N, want, args, D, r)` of the
    row-sharded array whose block here is local [N/D, ...]: one
    all_to_all with uneven splits, then each row to its place.  want must
    be a module-level function (it keys the cached tables)."""
    d, r, group = axis_info(mesh, axis)
    src_rows = int(local.shape[0]) * d
    _s, sent, received, _p, n_out = row_moves(src_rows, want, args, d, r)
    send_order, place = table(_move_tables, src_rows, want, args, d, r,
                              device=local.device)
    rest = tuple(local.shape[1:])
    send = local.index_select(0, send_order.long())
    recv = local.new_empty((sum(received),) + rest)
    count_collective()
    dist.all_to_all_single(recv, send, output_split_sizes=list(received),
                           input_split_sizes=list(sent), group=group)
    return local.new_empty((n_out,) + rest).index_copy_(0, place.long(),
                                                        recv)


def _monty(canon: np.ndarray) -> np.ndarray:
    return ((canon.astype(np.uint64) << np.uint64(32))
            % np.uint64(bb.P)).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _coeff_scale(log_n: int, dshift: int, d: int, r: int) -> np.ndarray:
    """Montgomery N^-1 · dshift^-i for the coefficients i = bitrev(j) of
    the rows j of rank r's block."""
    n = 1 << log_n
    i = nttm.bitrev_indices(log_n)[r * (n // d):(r + 1) * (n // d)]
    pw = nttm._powers_host(bb.h_inv(dshift), n)[i].astype(np.uint64)
    return _monty(pw * np.uint64(bb.h_inv(n)) % np.uint64(bb.P))


def _extend_wanted(d: int, q: int, log_n: int, log_blowup: int):
    """The coefficient rows (bit-reversed order) that rank q's block of the
    zero-padded [N·2^b] natural array holds: coefficient i sits at row
    bitrev(i)."""
    n_out = (1 << (log_n + log_blowup)) // d
    i = np.arange(q * n_out, min((q + 1) * n_out, 1 << log_n))
    return nttm.bitrev_indices(log_n)[i]


@functools.lru_cache(maxsize=None)
def _extend_scale(log_n: int, log_blowup: int, shift: int, factor: int,
                  d: int, r: int) -> np.ndarray:
    """Montgomery factor · shift^i for the coefficients i that rank r
    receives."""
    n_out = (1 << (log_n + log_blowup)) // d
    i = np.arange(r * n_out, min((r + 1) * n_out, 1 << log_n))
    pw = nttm._powers_host(shift, 1 << log_n)[i].astype(np.uint64)
    return _monty(pw * np.uint64(factor) % np.uint64(bb.P))


def dist_coeffs(evals_local: torch.Tensor, mesh, axis: str = "sp",
                dshift: int = 1) -> torch.Tensor:
    """Coefficients of the row-sharded evaluations on the coset dshift·H_N
    (this rank's block evals_local [N/D, ...], Montgomery): this rank's
    block of them in bit-reversed order, the order the inverse `dist_dif`
    leaves them (row j holds coefficient bitrev(j)).  Two all_to_alls."""
    d, r, _ = axis_info(mesh, axis)
    log_n = (int(evals_local.shape[0]) * d).bit_length() - 1
    scale = table(_coeff_scale, log_n, dshift % bb.P, d, r,
                  device=evals_local.device)
    rev = dist_dif(evals_local, mesh, axis, inverse=True)
    return bb.mul(rev, scale.reshape((-1,) + (1,) * (rev.dim() - 1)))


def dist_extend(coeffs_local: torch.Tensor, mesh, log_blowup: int,
                shift: int, axis: str = "sp",
                factor: int = 1) -> torch.Tensor:
    """Evaluations on the coset shift·H_{N·2^b}, bit-reversed, of the
    polynomials whose coefficients, times `factor`, are row-sharded in
    bit-reversed order (`dist_coeffs`' layout, this rank's block
    coeffs_local [N/D, ...], Montgomery): this rank's block [N·2^b/D,
    ...].  The bit-reversal and the zero padding move rows between ranks,
    in one all_to_all with uneven splits, where each row lands at its
    place in the padded array, scaled by factor^-1 · shift^i; then the
    forward `dist_dif`.  Three all_to_alls."""
    d, r, _ = axis_info(mesh, axis)
    log_n = (int(coeffs_local.shape[0]) * d).bit_length() - 1
    rest = tuple(coeffs_local.shape[1:])
    moved = move_rows(coeffs_local, mesh, axis, _extend_wanted,
                      (log_n, log_blowup))
    scale = table(_extend_scale, log_n, log_blowup, shift % bb.P,
                  bb.h_inv(factor % bb.P), d, r, device=coeffs_local.device)
    n_out = (1 << (log_n + log_blowup)) // d
    padded = torch.cat([
        bb.mul(moved, scale.reshape((-1,) + (1,) * len(rest))),
        moved.new_zeros((n_out - int(moved.shape[0]),) + rest)])
    return dist_dif(padded, mesh, axis, inverse=False)


def dist_eval(coeffs_local: torch.Tensor, mesh, shift: int,
              axis: str = "sp") -> torch.Tensor:
    """Evaluations on the coset shift·H_N, in natural order, of the
    polynomials whose coefficients are row-sharded in bit-reversed order
    (`dist_coeffs`' layout, this rank's block coeffs_local [N/D, ...],
    Montgomery): this rank's block, the rows of
    `ntt.coset_eval_from_coeffs`.  `dist_extend` without a blowup, then
    the bit-reversal moved back: four all_to_alls."""
    log_n = (int(coeffs_local.shape[0])
             * axis_info(mesh, axis)[0]).bit_length() - 1
    rev = dist_extend(coeffs_local, mesh, 0, shift, axis)
    # the rows of rank q's natural block sit at their bit-reversed places
    return move_rows(rev, mesh, axis, _extend_wanted, (log_n, 0))


def dist_coset_lde(evals_local: torch.Tensor, mesh, log_blowup: int,
                   shift: int, axis: str = "sp") -> torch.Tensor:
    """Low-degree extension of the row-sharded evaluations on H_N (this
    rank's block evals_local [N/D, ...], Montgomery) to the coset
    shift·H_{N·2^b}, bit-reversed: this rank's block [N·2^b/D, ...] of
    `ntt.coset_lde(evals, log_blowup, shift, out_bitrev=True)`.  The
    inverse `dist_dif` leaves N times the coefficients, which
    `dist_extend` scales once with shift^i: five all_to_alls."""
    n = int(evals_local.shape[0]) * axis_info(mesh, axis)[0]
    return dist_extend(dist_dif(evals_local, mesh, axis, inverse=True), mesh,
                       log_blowup, shift, axis, factor=n)
