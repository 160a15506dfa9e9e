"""Two-adic FRI polynomial commitment scheme: batch commit, batch open,
verify.

Counterpart of valida_tpu/commit/pcs.py.  LDEs, Merkle levels, opened
values and reduced openings are computed on the PCS's device (the card by
default; the NTT and hash kernels run there); the Fiat-Shamir transcript
and the verifier run on the host.  Opened values and proofs hold the JAX
package's values word for word.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..convert import from_reference
from ..crypto.merkle import MerkleTree, verify_openings
from ..device import resolve
from ..field import babybear as bb
from ..field import ext as extf
from ..poly import ntt as nttm
from . import fri as frim
from .fri import FriConfig, FriError, FriProof


@dataclasses.dataclass
class ProverData:
    """What the prover keeps of one commitment."""

    coeffs: list  # [h, w] coefficient matrices, natural order, Montgomery
    # [h * blowup, w] LDE matrices in bit-reversed row order, Montgomery:
    # the order the tree commits and FRI folds (the JAX package keeps the
    # natural order and gathers at each use; `ldes` gives that order)
    ldes_rev: list
    tree: MerkleTree  # over the canonical bit-reversed LDE rows
    log_heights: list  # log2 of the trace heights


@dataclasses.dataclass
class BatchOpening:
    opened_rows: list  # canonical uint32 rows, one per matrix of the round
    path: list


@dataclasses.dataclass
class PcsQueryProof:
    input_openings: list  # one BatchOpening per round
    fri_query: frim.FriQueryProof


@dataclasses.dataclass
class PcsProof:
    fri: FriProof
    query_proofs: list  # [PcsQueryProof]
    # canonical [h, w] coefficient matrices of the direct-opened tiny
    # matrices, rounds first (empty unless log_final > 0, see
    # fri.direct_open_threshold)
    direct_polys: list = dataclasses.field(default_factory=list)


def observe_direct_polys(challenger, direct_polys) -> None:
    """Bind the direct-opened coefficient matrices into the transcript
    (every canonical u32, row-major, matrices in round order).  Prover and
    verifier call it at the same place: after the opened values and before
    alpha, so the coefficients are fixed before the query indices are
    sampled."""
    for mat in direct_polys:
        for v in np.asarray(mat, dtype=np.uint32).reshape(-1):
            challenger.observe(int(v))


def _observe_opened(challenger, opened_values) -> None:
    for round_vals in opened_values:
        for mat_vals in round_vals:
            for point_vals in mat_vals:
                for val in point_vals:
                    challenger.observe_ext(val)


def _combine_host(apows, point_vals):
    """sum_c apows[c] * point_vals[c] over host ext tuples."""
    acc = extf.E_ZERO
    for a, y in zip(apows, point_vals):
        acc = extf.e_add(acc, extf.e_mul(a, y))
    return acc


class TwoAdicFriPcs:
    def __init__(self, config: FriConfig | None = None,
                 coset_shift: int = bb.GENERATOR, device="cuda"):
        self.config = config or FriConfig()
        self.shift = coset_shift % bb.P
        self.device = resolve(device)

    @property
    def log_blowup(self) -> int:
        return self.config.log_blowup

    def coset_shift(self) -> int:
        return self.shift

    # -- commit ------------------------------------------------------------

    def commit_batches(self, matrices, domain_shifts=None):
        """Commit a batch of trace matrices: canonical u32 [h, w] (numpy or
        int32 tensors), h a power of two, evaluations in natural order over
        shift_i·H_h.

        domain_shifts: the evaluation domain's shift for each matrix (1,
        the plain subgroup, by default).  Returns (root np.uint32[8],
        ProverData)."""
        if domain_shifts is None:
            domain_shifts = [1] * len(matrices)
        coeffs_list, ldes_rev, committed, log_heights = [], [], [], []
        for mat, dshift in zip(matrices, domain_shifts):
            if not isinstance(mat, torch.Tensor):
                mat = from_reference(np.asarray(mat))
            m = bb.to_monty(mat.to(self.device))
            log_heights.append(int(m.shape[0]).bit_length() - 1)
            coeffs = nttm.intt(m) if dshift == 1 else nttm.coset_intt(m, dshift)
            pad = coeffs.new_zeros((((1 << self.log_blowup) - 1)
                                    * coeffs.shape[0],) + coeffs.shape[1:])
            lde = nttm.coset_eval_from_coeffs(torch.cat([coeffs, pad], dim=0),
                                              self.shift, out_bitrev=True)
            coeffs_list.append(coeffs)
            ldes_rev.append(lde)
            committed.append(bb.from_monty(lde))
        tree = MerkleTree(committed, hasher=self.config.hasher)
        data = ProverData(coeffs=coeffs_list, ldes_rev=ldes_rev, tree=tree,
                          log_heights=log_heights)
        return tree.root(), data


    # -- open --------------------------------------------------------------


    # -- verify (host) -----------------------------------------------------

    def verify_multi_batches(self, rounds, dims, opened_values,
                             proof: PcsProof, challenger):
        """rounds: [(root, points_per_matrix)]; dims[r][m] = (height, width)
        of the committed trace matrix; opened_values as
        `open_multi_batches` returns them.  Raises FriError on a proof
        that does not hold."""
        config = self.config

        # structure first, so that a malformed proof fails with a FriError
        if len(proof.query_proofs) != config.num_queries:
            raise FriError(f"wrong query count: {len(proof.query_proofs)} "
                           f"!= {config.num_queries}")
        if len(proof.fri.query_proofs) != config.num_queries:
            raise FriError("wrong FRI query count")
        for qp in proof.query_proofs:
            if len(qp.input_openings) != len(rounds):
                raise FriError("wrong input-opening round count")
            for ri, rdims in enumerate(dims):
                opening = qp.input_openings[ri]
                if len(opening.opened_rows) != len(rdims):
                    raise FriError("wrong opened-row count")
                for (h, w), row in zip(rdims, opening.opened_rows):
                    if len(np.asarray(row).reshape(-1)) != int(w):
                        raise FriError("opened row width mismatch")
        for ri, (rdims, round_vals) in enumerate(zip(dims, opened_values)):
            if not len(rounds[ri][1]) == len(rdims) == len(round_vals):
                raise FriError("wrong matrix count in a round")

        log_max = max((int(h).bit_length() - 1) + self.log_blowup
                      for rdims in dims for (h, _w) in rdims)

        # direct-opened tiny matrices: shape-checked and bound into the
        # transcript before alpha and the query indices; the claimed
        # openings are checked against them here, the committed rows per
        # query below
        threshold = frim.direct_open_threshold(config)
        direct = {}  # (ri, mi) -> canonical [h, w] np.uint64 coefficients
        di = 0
        for ri, rdims in enumerate(dims):
            for mi, (h, w) in enumerate(rdims):
                log_lde = int(h).bit_length() - 1 + self.log_blowup
                if not frim.is_direct_mat(log_lde, log_max, threshold):
                    continue
                if di >= len(proof.direct_polys):
                    raise FriError("missing direct-opened polynomial")
                coeffs = np.asarray(proof.direct_polys[di], dtype=np.uint64)
                di += 1
                if coeffs.shape != (int(h), int(w)) or (coeffs >= bb.P).any():
                    raise FriError("malformed direct-opened polynomial")
                direct[(ri, mi)] = coeffs
        if di != len(proof.direct_polys):
            raise FriError("unexpected extra direct-opened polynomials")

        _observe_opened(challenger, opened_values)
        observe_direct_polys(challenger, proof.direct_polys)
        alpha = challenger.sample_ext()

        betas, indices = frim.fri_verify_challenges(proof.fri, config,
                                                    log_max, challenger)

        for (ri, mi), coeffs in direct.items():
            for z, point_vals in zip(rounds[ri][1][mi], opened_values[ri][mi]):
                zp = np.asarray(extf.e_powers(z, coeffs.shape[0]),
                                dtype=np.uint64)  # [h, 5]
                vals = np.zeros((coeffs.shape[1], 5), dtype=np.uint64)
                for d in range(5):
                    vals[:, d] = ((coeffs * zp[:, d:d + 1]) % bb.P
                                  ).sum(axis=0) % bb.P
                if not np.array_equal(vals, np.asarray(point_vals,
                                                       dtype=np.uint64)):
                    raise FriError("direct-opened polynomial disagrees with "
                                   "opened values")

        # the powers of alpha and the point-side combinations, once for
        # all queries
        total_width = sum(w for ri, rdims in enumerate(dims)
                          for mi, (_h, w) in enumerate(rdims)
                          if (ri, mi) not in direct)
        apows_all = extf.e_powers(alpha, max(total_width, 1))
        apows_np = np.asarray(apows_all, dtype=np.uint64)  # [W, 5]
        comb_ys = []  # [round][matrix][point] = sum_c alpha^(off+c) y_c
        off = 0
        for ri, (rdims, round_vals) in enumerate(zip(dims, opened_values)):
            round_comb = []
            for mi, ((h, w), mat_vals) in enumerate(zip(rdims, round_vals)):
                if (ri, mi) in direct:
                    round_comb.append(None)
                    continue
                round_comb.append([
                    _combine_host(apows_all[off:off + w], point_vals)
                    for point_vals in mat_vals])
                off += w
            comb_ys.append(round_comb)

        # Merkle paths: all queries of a round's tree in one batch
        idx_arr = np.asarray(indices, dtype=np.int64)
        for ri, ((root, points), rdims) in enumerate(zip(rounds, dims)):
            lde_dims = [(h << self.log_blowup, w) for (h, w) in rdims]
            tree_log_max = max(int(h).bit_length() - 1 for (h, _w) in lde_dims)
            rows_by_mat = [
                np.stack([np.asarray(qp.input_openings[ri].opened_rows[mi],
                                     dtype=np.uint32)
                          for qp in proof.query_proofs])
                for mi in range(len(rdims))
            ]
            paths = np.stack([
                np.asarray(qp.input_openings[ri].path, dtype=np.uint32)
                for qp in proof.query_proofs])
            if not verify_openings(
                    root, lde_dims, idx_arr >> (log_max - tree_log_max),
                    rows_by_mat, paths, hasher=config.hasher):
                raise FriError(f"bad input opening (round {ri})")

        ros = []
        for qi, idx in enumerate(indices):
            qp = proof.query_proofs[qi]
            ro = {}
            alpha_offset = 0
            for ri, ((root, points), rdims) in enumerate(zip(rounds, dims)):
                opening = qp.input_openings[ri]
                for mi, ((h, w), mat_points) in enumerate(zip(rdims, points)):
                    log_lde = int(h).bit_length() - 1 + self.log_blowup
                    row = np.asarray(opening.opened_rows[mi], dtype=np.uint64)
                    mat_idx = idx >> (log_max - log_lde)
                    x = (self.shift
                         * pow(bb.two_adic_generator(log_lde),
                               frim._bitrev_int(mat_idx, log_lde), bb.P)
                         % bb.P)
                    if (ri, mi) in direct:
                        # the Merkle-verified row must equal the shipped
                        # polynomial at this query's point
                        coeffs = direct[(ri, mi)]
                        xpow = np.empty(coeffs.shape[0], dtype=np.uint64)
                        acc_x = 1
                        for i in range(coeffs.shape[0]):
                            xpow[i] = acc_x
                            acc_x = acc_x * x % bb.P
                        vals = ((coeffs * xpow[:, None]) % bb.P
                                ).sum(axis=0) % bb.P
                        if not np.array_equal(vals, row % bb.P):
                            raise FriError("direct-opened polynomial "
                                           "disagrees with committed row")
                        continue
                    # comb_row = sum_c alpha^(off+c) row_c: each product is
                    # below p^2 < 2^62 and reduced before the sum
                    ap = apows_np[alpha_offset:alpha_offset + w]
                    terms = ap * row[:, None] % bb.P
                    comb_row = tuple(int(v) for v in terms.sum(axis=0) % bb.P)
                    acc = ro.get(log_lde, extf.E_ZERO)
                    for z, comb_y in zip(mat_points, comb_ys[ri][mi]):
                        num = extf.e_sub(comb_row, comb_y)
                        den = extf.e_sub(extf.e_from_base(x), z)
                        acc = extf.e_add(acc, extf.e_mul(num, extf.e_inv(den)))
                    ro[log_lde] = acc
                    alpha_offset += w
            ros.append(ro)
        frim.verify_queries_fold(
            [qp.fri_query for qp in proof.query_proofs], proof.fri, config,
            betas, indices, log_max, self.shift, ros)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


