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


def dist_dif_applies(log_h: int, mesh, axis: str = "sp") -> bool:
    """Whether `dist_dif` takes a transform of 2^log_h rows over `axis`:
    a 128-point first step, whole column slices and whole blocks on every
    rank (valida_tpu/machine/jit_prover.py::_dist_dif_applies)."""
    if mesh is None or axis not in tuple(mesh.mesh_dim_names or ()):
        return False
    d = axis_info(mesh, axis)[0]
    return log_h >= LOG_B and B % d == 0 and ((1 << log_h) >> LOG_B) % d == 0


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
    dist.all_to_all_single(y, x, group=group)  # [D, 128/D, M/D, cols]
    # 2. the 128-point step and the twiddles of this rank's columns
    y = nttm.dif(y.reshape(B, md * cols), inverse)
    tw = table(_step_twiddles, log_n, inverse, d, r, device=a_local.device)
    y = bb.mul(y.reshape(B, md, cols), tw[:, :, None])
    # 3. chunk j: rank j's rows of the view at this rank's columns
    z = torch.empty_like(y)
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
def _lde_moves(log_n: int, log_blowup: int, d: int, r: int):
    """How rank r's rows move between the two transforms of an LDE.  Row
    j of the inverse transform's output is the coefficient i = bitrev(j);
    it goes to the rank whose block of the padded [N·2^b] array holds row
    i.  Returns (the local rows in the order they are sent, the rows sent
    to each rank, the rows received from each rank, the coefficient index
    i of each received row in the order it arrives)."""
    n_in = (1 << log_n) // d
    n_out = (1 << (log_n + log_blowup)) // d
    rev = nttm.bitrev_indices(log_n).astype(np.int64)
    mine = rev[r * n_in:(r + 1) * n_in]
    send_counts = np.bincount(mine // n_out, minlength=d)
    # from each rank s, in rank order: its coefficients bound here, ascending
    recv_i = [np.sort(blk[blk // n_out == r])
              for blk in rev.reshape(d, n_in)]
    return (np.argsort(mine, kind="stable"),
            tuple(int(c) for c in send_counts),
            tuple(len(v) for v in recv_i), np.concatenate(recv_i))


@functools.lru_cache(maxsize=None)
def _lde_tables(log_n: int, log_blowup: int, shift: int, d: int, r: int):
    """Device tables of `dist_coset_lde` on rank r: (send order, the row
    of the padded block each received row lands at, its Montgomery scale
    shift^i / N), u32."""
    send_order, _sent, _received, recv_i = _lde_moves(log_n, log_blowup, d,
                                                      r)
    n_out = (1 << (log_n + log_blowup)) // d
    powers = nttm._powers_host(shift, 1 << log_n).astype(np.uint64)
    scale = (powers[recv_i] * np.uint64(bb.h_inv(1 << log_n))
             % np.uint64(bb.P))
    scale = (scale << np.uint64(32)) % np.uint64(bb.P)
    return (send_order.astype(np.uint32),
            (recv_i - r * n_out).astype(np.uint32), scale.astype(np.uint32))


def dist_coset_lde(evals_local: torch.Tensor, mesh, log_blowup: int,
                   shift: int, axis: str = "sp") -> torch.Tensor:
    """Low-degree extension of the row-sharded evaluations on H_N (this
    rank's block evals_local [N/D, ...], Montgomery) to the coset
    shift·H_{N·2^b}, bit-reversed: this rank's block [N·2^b/D, ...] of
    `ntt.coset_lde(evals, log_blowup, shift, out_bitrev=True)`.

    The inverse `dist_dif` leaves the coefficients in bit-reversed order,
    block by block; the bit-reversal gather and the zero-padding move rows
    between ranks, in one all_to_all with uneven splits, where each row
    lands at its place in the padded array, scaled by shift^i / N.  Then
    the forward `dist_dif`.  Five all_to_alls per LDE: two per transform
    and the move between them."""
    d, r, group = axis_info(mesh, axis)
    n = int(evals_local.shape[0]) * d
    log_n = n.bit_length() - 1
    rest = tuple(evals_local.shape[1:])
    dev = evals_local.device
    coeffs_rev = dist_dif(evals_local, mesh, axis, inverse=True)
    _o, send_counts, recv_counts, _i = _lde_moves(log_n, log_blowup, d, r)
    send_order, place, scale = table(_lde_tables, log_n, log_blowup,
                                     shift % bb.P, d, r, device=dev)
    send = coeffs_rev.index_select(0, send_order.long())
    recv = send.new_empty((sum(recv_counts),) + rest)
    dist.all_to_all_single(recv, send, output_split_sizes=list(recv_counts),
                           input_split_sizes=list(send_counts), group=group)
    padded = send.new_zeros(((n << log_blowup) // d,) + rest)
    padded[place.long()] = bb.mul(recv,
                                  scale.reshape((-1,) + (1,) * len(rest)))
    return dist_dif(padded, mesh, axis, inverse=False)
