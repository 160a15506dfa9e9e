"""Batch FRI low-degree proof over bit-reversed two-adic coset domains.

Counterpart of valida_tpu/commit/fri.py:

* All committed evaluation vectors are in bit-reversed order, so the fold
  pair (x, -x) sits at adjacent indices (2i, 2i+1) and a Merkle query index
  carries over from layer to layer by a right shift.
* Commit phase: fold by 2 with a challenger-sampled beta; each layer is
  committed as a pair matrix [M/2, 2*5] (extension values flattened to base
  columns); reduced openings of smaller heights are added as the fold
  reaches their size.
* After the final polynomial: the proof-of-work grind, then the query
  indices.

Fold rule at the pair (e0, e1), x0 the even point:
    p'(x0^2) = (e0 + e1)/2 + beta * (e0 - e1) / (2 x0)

The prover's arrays are int32 tensors on one device; the Merkle trees hash
there (the Poseidon2 or Keccak kernel on a CUDA tensor); the transcript and
the verifier run on the host.  A proof holds numpy u32 arrays, tuples and
ints, exactly the JAX package's values.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..convert import from_reference, table, to_numpy
from ..crypto import poseidon
from ..crypto.merkle import MerkleTree, verify_opening, verify_openings
from ..field import babybear as bb
from ..field import ext as extf
from ..poly import ntt as nttm
from ..poly.ntt import _powers_host, bitrev_indices


@dataclasses.dataclass
class FriConfig:
    log_blowup: int = 1
    num_queries: int = 40
    proof_of_work_bits: int = 8
    hasher: str = "keccak"  # "keccak" | "poseidon2": the Merkle hasher
    # Folding stops when the layer holds 2^(log_blowup + log_final) values,
    # and the proof carries the final polynomial's 2^log_final coefficients
    # (0: fold to a constant).
    log_final: int = 0


@dataclasses.dataclass
class CommitPhaseOpening:
    pair_row: np.ndarray  # uint32 [10]: both pair values, base-flattened
    path: list


@dataclasses.dataclass
class FriQueryProof:
    commit_phase_openings: list  # one per commit-phase layer


@dataclasses.dataclass
class FriProof:
    commit_phase_commits: list  # roots, np.uint32[8]
    # log_final == 0: one ext scalar (5-tuple of canonical ints), the
    # constant final value.  log_final > 0: a tuple of 2^log_final ext
    # tuples, the final polynomial's coefficients, low degree first.
    final_poly: tuple
    pow_witness: int
    query_proofs: list  # [FriQueryProof]


class FriError(Exception):
    pass


def final_poly_coeffs(final_poly) -> list:
    """Either final_poly format as a list of coefficients."""
    if final_poly and isinstance(final_poly[0], (tuple, list)):
        return [tuple(int(x) for x in c) for c in final_poly]
    return [tuple(int(x) for x in final_poly)]


def check_final_poly_shape(proof: FriProof, config: FriConfig,
                           log_stop: int) -> None:
    """The final polynomial must have exactly 2^(log_stop - log_blowup)
    coefficients: with more, a prover could interpolate the last layer of
    data of any degree and every fold check would pass.  With log_final ==
    0 it must also be a single constant, not a list."""
    nested = bool(proof.final_poly) and isinstance(
        proof.final_poly[0], (tuple, list))
    if config.log_final == 0 and nested:
        raise FriError(
            "final polynomial must be a single constant when log_final == 0")
    n = len(final_poly_coeffs(proof.final_poly))
    expect = 1 << max(0, log_stop - config.log_blowup)
    if n != expect:
        raise FriError(
            f"final polynomial has {n} coefficients, expected {expect}")


def direct_open_threshold(config: FriConfig) -> int:
    """Matrices whose LDE height is at most 2^threshold are opened
    directly: their whole coefficient matrix goes into the proof, and the
    verifier evaluates it at the opening points and at every query's
    domain point against the Merkle-opened row.  They take no part in the
    folding, so one tiny matrix does not clamp `fri_log_stop` for all.
    -1 (when log_final == 0) disables it."""
    if config.log_final <= 0:
        return -1
    return config.log_blowup + config.log_final


def is_direct_mat(log_lde: int, log_max: int, threshold: int) -> bool:
    """Whether a matrix is opened directly: at or under the threshold, and
    never the largest matrix (FRI needs the top height)."""
    return log_lde <= threshold and log_lde < log_max


def fri_log_stop(config: FriConfig, log_max: int, min_height: int) -> int:
    """log2 of the final evaluation layer's size.  Clamped so that every
    reduced opening's height is still reached by the folding."""
    return max(config.log_blowup,
               min(config.log_blowup + config.log_final, min_height, log_max))


# ---------------------------------------------------------------------------
# domain tables
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _x0_inv_table(log_m: int, shift: int) -> np.ndarray:
    """1/x0 for each fold pair of a layer of 2^log_m values on the coset
    with `shift`: x0(pair i) = shift * g^brev(i), g of order 2^log_m, so
    1/x0 = shift^-1 * (g^-1)^brev(i), taken from a table of powers with
    no inversion per element.  Montgomery np.uint32 [2^(log_m-1)]."""
    half = 1 << (log_m - 1)
    g_inv = bb.h_inv(bb.two_adic_generator(log_m))
    pw = _powers_host(g_inv, half).astype(np.uint64)
    if log_m - 1 > 0:
        pw = pw[bitrev_indices(log_m - 1)]
    inv = pw * np.uint64(bb.h_inv(shift % bb.P)) % np.uint64(bb.P)
    return ((inv << 32) % np.uint64(bb.P)).astype(np.uint32)


def layer_shift(base_shift: int, layer: int) -> int:
    """Coset shift of fold layer `layer` (0 = the input domain)."""
    s = base_shift % bb.P
    for _ in range(layer):
        s = s * s % bb.P
    return s


def _ext_to_base_matrix(v: torch.Tensor) -> torch.Tensor:
    """[M, 5] ext Montgomery -> [M/2, 10] canonical pair matrix."""
    return bb.from_monty(v).reshape(v.shape[0] // 2, 10)


def fold_device(v: torch.Tensor, beta: torch.Tensor,
                x0_inv: torch.Tensor) -> torch.Tensor:
    """One FRI fold.  v: [M, 5] ext Montgomery in bit-reversed order; beta:
    [5] ext Montgomery; x0_inv: [M/2] base Montgomery.  Returns [M/2, 5]."""
    e0 = v[0::2]
    e1 = v[1::2]
    d = extf.ext_mul_base(bb.sub(e0, e1), x0_inv)
    d = extf.ext_mul(d, beta[None, :])
    return bb.mul(bb.add(bb.add(e0, e1), d), bb.monty_scalar(bb.h_inv(2)))


def extract_final_poly(current: torch.Tensor, config: FriConfig,
                       log_max: int, log_stop: int, shift: int, challenger):
    """current: [2^log_stop, 5] ext Montgomery evaluations in bit-reversed
    order after the last fold, on the squared coset.  Interpolates the
    final polynomial, requires the coefficients above the degree bound to
    vanish (FRI's conclusion), observes the rest and returns the proof's
    final_poly field."""
    m = 1 << log_stop
    nat = (current[table(bitrev_indices, log_stop,
                         device=current.device).long()]
           if log_stop > 0 else current)
    s_fin = layer_shift(shift, log_max - log_stop)
    coeffs = to_numpy(bb.from_monty(nttm.coset_intt(nat, s_fin)))  # [m, 5]
    n_keep = max(1, m >> config.log_blowup)
    if coeffs[n_keep:].any():
        raise FriError("final FRI polynomial exceeds the degree bound")
    if n_keep == 1:
        final_poly = tuple(int(v) for v in coeffs[0])
        challenger.observe_ext(final_poly)
        return final_poly
    final_poly = tuple(tuple(int(v) for v in row) for row in coeffs[:n_keep])
    for c in final_poly:
        challenger.observe_ext(c)
    return final_poly


# ---------------------------------------------------------------------------
# proof-of-work grind (batched Poseidon search)
# ---------------------------------------------------------------------------


def grind_device(challenger, bits: int, device="cuda") -> int:
    """The smallest witness w such that observing w and then sampling
    `bits` bits gives 0, searched in ascending batches of Poseidon
    permutations on `device`.

    As DuplexChallenger.grind: observe(w) appends to the input buffer, and
    sample() duplexes and pops state[WIDTH - 1]."""
    pending = list(challenger.input_buffer)
    k = len(pending)
    if k + 1 >= poseidon.WIDTH:
        raise RuntimeError("input buffer overflow during grind")
    base = np.array(challenger.state, dtype=np.uint32)
    base[:k] = pending
    base_m = bb.to_monty(from_reference(base, device))
    mask = (1 << bits) - 1

    def attempt(start: int, batch: int) -> int:
        cand = start + torch.arange(batch, dtype=torch.int64, device=device)
        st = base_m.repeat(batch, 1)
        st[:, k] = bb.to_monty(cand)
        out = poseidon.permute_device(st)
        last = bb.from_monty(out[:, poseidon.WIDTH - 1])
        ok = (last & mask) == 0
        if not bool(ok.any()):
            return -1
        return int(cand[ok.nonzero()[0, 0]])  # the first hit

    # about 2^bits candidates are expected: start small, grow the batch
    start = 0
    batch = max(64, min(1 << 14, 4 << bits))
    while start < bb.P:
        w = attempt(start, batch)
        if w >= 0:
            challenger.observe(w)
            if challenger.sample_bits(bits) != 0:
                raise RuntimeError("grind: witness does not replay")
            return w
        start += batch
        batch = min(batch * 2, 1 << 16)
    raise RuntimeError("grind failed")


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------


def fri_prove(reduced_openings: dict, config: FriConfig, shift: int,
              challenger):
    """The FRI commit and query phases.

    reduced_openings: {log_m: [2^log_m, 5] ext Montgomery tensor in
    bit-reversed order}, the alpha-combined opening quotients per LDE
    height.  Returns (FriProof, query_indices)."""
    log_max = max(reduced_openings)
    log_min = fri_log_stop(config, log_max, min(reduced_openings))
    current = reduced_openings[log_max]
    dev = current.device

    commits = []
    trees = []
    for layer, log_m in enumerate(range(log_max, log_min, -1)):
        tree = MerkleTree([_ext_to_base_matrix(current)],
                          hasher=config.hasher)
        trees.append(tree)
        commits.append(tree.root())
        challenger.observe_digest(tree.root())
        beta = challenger.sample_ext()
        x0inv = table(_x0_inv_table, log_m, layer_shift(shift, layer),
                      device=dev)
        current = fold_device(current, extf.ext_const(beta, dev), x0inv)
        if log_m - 1 in reduced_openings:
            current = bb.add(current, reduced_openings[log_m - 1])

    final_poly = extract_final_poly(current, config, log_max, log_min, shift,
                                    challenger)
    pow_witness = grind_device(challenger, config.proof_of_work_bits, dev)
    query_indices = [challenger.sample_bits(log_max)
                     for _ in range(config.num_queries)]

    # one batched open per layer tree: one copy to the host each
    per_layer = [
        tree.open_many([idx >> (layer_i + 1) for idx in query_indices])
        for layer_i, tree in enumerate(trees)
    ]
    query_proofs = [
        FriQueryProof(commit_phase_openings=[
            CommitPhaseOpening(pair_row=opened[qi][0][0], path=opened[qi][1])
            for opened in per_layer])
        for qi in range(len(query_indices))
    ]
    proof = FriProof(commit_phase_commits=commits, final_poly=final_poly,
                     pow_witness=pow_witness, query_proofs=query_proofs)
    return proof, query_indices


# ---------------------------------------------------------------------------
# verifier (host)
# ---------------------------------------------------------------------------


def fri_verify_challenges(proof: FriProof, config: FriConfig, log_max: int,
                          challenger):
    """Replay the transcript: betas, the proof-of-work check, the query
    indices."""
    betas = []
    for root in proof.commit_phase_commits:
        challenger.observe_digest(root)
        betas.append(challenger.sample_ext())
    for c in final_poly_coeffs(proof.final_poly):
        challenger.observe_ext(c)
    if not challenger.check_witness(config.proof_of_work_bits,
                                    proof.pow_witness):
        raise FriError("proof-of-work check failed")
    indices = [challenger.sample_bits(log_max)
               for _ in range(config.num_queries)]
    return betas, indices


def _check_layer_counts(n_openings, proof: FriProof, config: FriConfig,
                        log_max: int, log_stop: int) -> None:
    n_layers = log_max - log_stop
    if len(proof.commit_phase_commits) != n_layers:
        raise FriError(
            f"wrong number of commit-phase layers: "
            f"{len(proof.commit_phase_commits)} != {n_layers}")
    check_final_poly_shape(proof, config, log_stop)
    for n in n_openings:
        if n != n_layers:
            raise FriError(f"query proof has {n} commit-phase openings, "
                           f"expected {n_layers}")


def verify_queries_fold(query_proofs, proof: FriProof, config: FriConfig,
                        betas, indices, log_max: int, shift: int,
                        ros) -> None:
    """All queries at once: for each commit-phase layer one batched Merkle
    verification across the queries, then the scalar fold arithmetic of
    each query."""
    log_stop = fri_log_stop(config, log_max, min(ros[0]) if ros else log_max)
    _check_layer_counts([len(qp.commit_phase_openings) for qp in query_proofs],
                        proof, config, log_max, log_stop)
    idx = np.asarray(indices, dtype=np.int64)
    for layer, log_m in enumerate(range(log_max, log_stop, -1)):
        pair_idx = idx >> 1
        rows = np.stack([
            np.asarray(qp.commit_phase_openings[layer].pair_row,
                       dtype=np.uint32) for qp in query_proofs])
        paths = np.stack([
            np.asarray(qp.commit_phase_openings[layer].path, dtype=np.uint32)
            for qp in query_proofs])
        if not verify_openings(
                proof.commit_phase_commits[layer], [(1 << (log_m - 1), 10)],
                pair_idx, [rows], paths, hasher=config.hasher):
            raise FriError(f"bad commit-phase Merkle path at layer {layer}")
        idx = pair_idx
    for qp, index, ro in zip(query_proofs, indices, ros):
        _verify_query_fold_values(qp, proof, config, betas, int(index),
                                  log_max, shift, ro)


def verify_query_fold(query_proof: FriQueryProof, proof: FriProof,
                      config: FriConfig, betas, index: int, log_max: int,
                      shift: int, ro_at_index: dict) -> None:
    """One query: the Merkle path of every layer, then the fold values."""
    log_stop = fri_log_stop(config, log_max, min(ro_at_index) if ro_at_index
                            else log_max)
    _check_layer_counts([len(query_proof.commit_phase_openings)], proof,
                        config, log_max, log_stop)
    idx = index
    for layer, log_m in enumerate(range(log_max, log_stop, -1)):
        opening = query_proof.commit_phase_openings[layer]
        pair_index = idx >> 1
        if not verify_opening(
                proof.commit_phase_commits[layer], [(1 << (log_m - 1), 10)],
                pair_index, [opening.pair_row], opening.path,
                hasher=config.hasher):
            raise FriError(f"bad commit-phase Merkle path at layer {layer}")
        idx = pair_index
    _verify_query_fold_values(query_proof, proof, config, betas, index,
                              log_max, shift, ro_at_index)


def _verify_query_fold_values(query_proof: FriQueryProof, proof: FriProof,
                              config: FriConfig, betas, index: int,
                              log_max: int, shift: int,
                              ro_at_index: dict) -> None:
    log_stop = fri_log_stop(config, log_max, min(ro_at_index) if ro_at_index
                            else log_max)
    value = ro_at_index[log_max]
    idx = index
    inv2 = bb.h_inv(2)
    for layer, log_m in enumerate(range(log_max, log_stop, -1)):
        opening = query_proof.commit_phase_openings[layer]
        pair_index = idx >> 1
        row = np.asarray(opening.pair_row, dtype=np.uint64)
        e0 = tuple(int(v) for v in row[0:5])
        e1 = tuple(int(v) for v in row[5:10])
        mine = e0 if (idx & 1) == 0 else e1
        if mine != tuple(value):
            raise FriError(f"fold value mismatch at layer {layer}")
        x0 = (layer_shift(shift, layer)
              * pow(bb.two_adic_generator(log_m),
                    _bitrev_int(pair_index, log_m - 1), bb.P) % bb.P)
        d = extf.e_scale(extf.e_sub(e0, e1), bb.h_inv(x0))
        d = extf.e_mul(d, betas[layer])
        value = extf.e_scale(extf.e_add(extf.e_add(e0, e1), d), inv2)
        idx = pair_index
        if log_m - 1 in ro_at_index:
            value = extf.e_add(value, ro_at_index[log_m - 1])
    # the final polynomial at this query's point of the final (squared
    # coset) domain: x = s_fin * g^brev(idx)
    s_fin = layer_shift(shift, log_max - log_stop)
    x = (s_fin * pow(bb.two_adic_generator(log_stop),
                     _bitrev_int(idx, log_stop), bb.P) % bb.P)
    ev = extf.E_ZERO
    for c in reversed(final_poly_coeffs(proof.final_poly)):
        ev = extf.e_add(extf.e_scale(ev, x), c)
    if tuple(value) != tuple(ev):
        raise FriError("final polynomial mismatch")


def _bitrev_int(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r
