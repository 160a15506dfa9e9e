"""Moving u32 arrays between the reference's numpy form and the port's
int32 tensors (bit views, no value change)."""

from __future__ import annotations

import numpy as np
import torch

from .utils import span


def _check_transfer(what: str, device) -> None:
    """Raise inside a CUDA graph capture (machine/jit_prover.py)."""
    if (torch.device(device).type == "cuda"
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(f"{what} inside a captured stage: the graph would "
                           f"replay a stale host buffer (make the array a "
                           f"`table` built by the stage's eager first run)")


def from_reference(arr, device="cpu") -> torch.Tensor:
    """u32 array (trace, table, digests; any integer dtype whose values fit
    in 32 bits) -> int32 tensor holding the same bit patterns (an upload to
    a CUDA device is the span "upload")."""
    _check_transfer("a host upload", device)
    if torch.device(device).type != "cuda":
        return _host_words(arr)
    with span("upload"):
        # from page-locked memory the copy is queued behind the device's
        # work instead of waiting for it
        return _host_words(arr).pin_memory().to(device, non_blocking=True)


def _host_words(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype != np.uint32:
        if a.size and (a.min() < 0 or a.max() > 0xFFFFFFFF):
            raise ValueError("values do not fit in u32")
        a = a.astype(np.uint32)
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32).copy())


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> np.uint32 array with the same bits (a CUDA tensor's
    copy is the span "fetch")."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected int32, got {t.dtype}")
    _check_transfer("a copy to the host", t.device)
    if t.device.type != "cuda":
        return _host_array(t)
    with span("fetch"):
        return _host_array(t)


def _host_array(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32).copy()


def to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 holding values in [0, 2^32) -> int32 with the same low bits."""
    return (((v & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def u32_as_int64(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return t.to(torch.int64) & 0xFFFFFFFF


_TABLES: dict = {}


def table(make, *args, device):
    """Device copy of the host table `make(*args)` (a cached numpy
    function returning an array or a tuple of arrays), made once per
    device."""
    key = (make, args, str(device))
    t = _TABLES.get(key)
    if t is None:
        arr = make(*args)
        t = (tuple(from_reference(a, device) for a in arr)
             if isinstance(arr, tuple) else from_reference(arr, device))
        _TABLES[key] = t
    return t


_INDICES: dict = {}


def index_tensor(indices: tuple, device) -> torch.Tensor:
    """int64 tensor of fixed indices on `device`, made once (a Python list
    as an index is copied to the device at every use)."""
    key = (tuple(indices), str(device))
    t = _INDICES.get(key)
    if t is None:
        t = _INDICES[key] = from_reference(
            np.asarray(key[0], dtype=np.uint32), device).long()
    return t


# ---------------------------------------------------------------------------
# PCS proofs across the two packages
# ---------------------------------------------------------------------------
#
# A proof of either package holds numpy u32 arrays, tuples and python ints
# under the same field names; only the dataclasses differ.  The two
# functions below rebuild one package's dataclasses from the other's
# values, so a proof made by one can be handed to the other's verifier.
# The reference's classes are passed in (its modules commit.fri and
# commit.pcs), since this package imports nothing of it.


def _rebuild_proof(proof, fri_mod, pcs_mod):
    def words(a):
        return np.array(a, dtype=np.uint32)

    def final(fp):
        if fp and isinstance(fp[0], (tuple, list)):
            return tuple(tuple(int(x) for x in c) for c in fp)
        return tuple(int(x) for x in fp)

    def fri_query(q):
        return fri_mod.FriQueryProof(commit_phase_openings=[
            fri_mod.CommitPhaseOpening(pair_row=words(op.pair_row),
                                       path=[words(d) for d in op.path])
            for op in q.commit_phase_openings])

    fri_queries = [fri_query(q) for q in proof.fri.query_proofs]
    fri = fri_mod.FriProof(
        commit_phase_commits=[words(r) for r in proof.fri.commit_phase_commits],
        final_poly=final(proof.fri.final_poly),
        pow_witness=int(proof.fri.pow_witness),
        query_proofs=fri_queries)
    queries = [
        pcs_mod.PcsQueryProof(
            input_openings=[
                pcs_mod.BatchOpening(
                    opened_rows=[words(r) for r in op.opened_rows],
                    path=[words(d) for d in op.path])
                for op in qp.input_openings],
            fri_query=fq)
        for qp, fq in zip(proof.query_proofs, fri_queries)]
    return pcs_mod.PcsProof(fri=fri, query_proofs=queries,
                            direct_polys=[words(m) for m in proof.direct_polys])


def proof_from_reference(proof):
    """A PcsProof of the JAX package -> this package's PcsProof."""
    from .commit import fri, pcs

    return _rebuild_proof(proof, fri, pcs)


def proof_to_reference(proof, ref_fri, ref_pcs):
    """This package's PcsProof -> the JAX package's, whose modules
    commit.fri and commit.pcs the caller passes in."""
    return _rebuild_proof(proof, ref_fri, ref_pcs)


# ---------------------------------------------------------------------------
# Machine proofs across the two packages
# ---------------------------------------------------------------------------
#
# Machines are carried across by building them from the same seed in each
# package; their proofs by the two functions below, field by field.


def _rebuild_machine_proof(proof, proof_mod, fri_mod, pcs_mod):
    def ext(e):
        return tuple(int(x) for x in e)

    def exts(vals):
        return [ext(v) for v in vals]

    c = proof.commitments
    commitments = proof_mod.Commitments(
        preprocessed=np.array(c.preprocessed, dtype=np.uint32),
        main_trace=np.array(c.main_trace, dtype=np.uint32),
        perm_trace=np.array(c.perm_trace, dtype=np.uint32),
        quotient_chunks=np.array(c.quotient_chunks, dtype=np.uint32))
    chip_proofs = []
    for cp in proof.chip_proofs:
        ov = cp.opened_values
        chip_proofs.append(proof_mod.ChipProof(
            log_degree=int(cp.log_degree),
            opened_values=proof_mod.OpenedValues(
                preprocessed_local=exts(ov.preprocessed_local),
                preprocessed_next=exts(ov.preprocessed_next),
                trace_local=exts(ov.trace_local),
                trace_next=exts(ov.trace_next),
                permutation_local=exts(ov.permutation_local),
                permutation_next=exts(ov.permutation_next),
                quotient_chunks=exts(ov.quotient_chunks)),
            cumulative_sum=ext(cp.cumulative_sum)))
    return proof_mod.MachineProof(
        commitments=commitments,
        opening_proof=_rebuild_proof(proof.opening_proof, fri_mod, pcs_mod),
        chip_proofs=chip_proofs)


def machine_proof_from_reference(proof):
    """A MachineProof of the JAX package -> this package's MachineProof."""
    from .commit import fri, pcs
    from .core import proof as proof_mod

    return _rebuild_machine_proof(proof, proof_mod, fri, pcs)


def machine_proof_to_reference(proof, ref_modules):
    """This package's MachineProof -> the JAX package's.  ref_modules is
    the JAX package's (core.proof, commit.fri, commit.pcs) modules, which
    the caller passes in."""
    proof_mod, fri_mod, pcs_mod = ref_modules
    return _rebuild_machine_proof(proof, proof_mod, fri_mod, pcs_mod)
