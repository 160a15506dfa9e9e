"""The device mesh and the sharded steps of the prover's bulk work.

Counterpart of valida_tpu/parallel/mesh.py, on torch.distributed: one
process per device, every rank running the same code on its shard.  The
mesh has two axes: "dp" splits the batch of independent traces, "sp"
splits the rows of each trace into contiguous blocks.  The JAX package
states shardings and lets its compiler insert the collectives; here each
collective is written out:
  * the commit's LDE runs `dist_coset_lde` over "sp" (five all_to_alls),
    or, below `dist_dif_applies`' bounds, gathers the rows and extends
    them on every rank;
  * each rank's block of the bit-reversed LDE is a contiguous subtree of
    the Merkle tree: it is reduced to one digest, the digests are
    all_gathered over "sp", and the top log2(sp) levels finish the root;
  * the LogUp running sum is a local prefix sum plus the totals of the
    lower "sp" ranks (one all_gather);
  * `sharded_prove_fn` all_gathers the results over "dp".
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..convert import from_reference, u32_as_int64
from ..crypto.keccak import keccak256_words
from ..crypto.merkle import DIGEST_WORDS, compress_pairs
from ..device import resolve
from ..field import babybear as bb
from ..field.ext import ext_mul_base
from ..poly import ntt as nttm
from .dist_ntt import axis_info, dist_coset_lde, dist_dif_applies

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(n_devices: int | None = None, dp: int = 1, device="cuda"):
    """DeviceMesh of shape (dp, n/dp) named ("dp", "sp") over the ranks of
    the initialised process group, whose world size must be n_devices (by
    default it is taken as n).  On "cuda" the group must be NCCL, on "cpu"
    gloo."""
    dev = resolve(device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process group "
            "of one process per device (parallel/dryrun.py::run_ranks, or "
            "torchrun)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"make_mesh({n}): the process group has {world} "
                         f"ranks")
    if dp < 1 or n % dp:
        raise ValueError(f"dp = {dp} does not divide {n} devices")
    backend = str(dist.get_backend())
    if backend != _BACKEND[dev.type]:
        raise ValueError(f"make_mesh on {dev.type} needs a "
                         f"{_BACKEND[dev.type]} process group, got {backend}")
    return init_device_mesh(dev.type, (dp, n // dp),
                            mesh_dim_names=("dp", "sp"))


def _all_gather(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """[size, *t.shape]: t of every rank of `group`, in rank order."""
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def _tree_tops(d: torch.Tensor) -> torch.Tensor:
    """[B, h, 8] digests of B trees' level h -> [B, 8] roots (Keccak)."""
    b = d.shape[0]
    while d.shape[1] > 1:
        d = compress_pairs(d.reshape(-1, DIGEST_WORDS)).reshape(
            b, -1, DIGEST_WORDS)
    return d[:, 0]


def commit_step(traces: torch.Tensor, mesh) -> torch.Tensor:
    """Batched trace commit of this rank's block [B/dp, N/sp, C] (canonical
    int32) -> the roots [B/dp, 8] of its B/dp traces, on every "sp" rank:
    to_monty, coset LDE (blowup 2, `bb.GENERATOR`, bit-reversed),
    from_monty, Keccak leaves, pairwise Keccak compression."""
    sp, r, group = axis_info(mesh, "sp")
    b_l, n_l, c = traces.shape
    log_n = (n_l * sp).bit_length() - 1
    m = bb.to_monty(traces).transpose(0, 1).contiguous()  # [N/sp, B/dp, C]
    if dist_dif_applies(log_n, mesh, "sp"):
        lde = dist_coset_lde(m, mesh, 1, bb.GENERATOR)
    else:
        whole = _all_gather(m, group, sp).reshape(n_l * sp, b_l, c)
        lde = nttm.coset_lde(whole, 1, bb.GENERATOR, out_bitrev=True)[
            2 * n_l * r:2 * n_l * (r + 1)]
    rows = bb.from_monty(lde.transpose(0, 1).contiguous())  # [B/dp, 2N/sp, C]
    d = keccak256_words(rows.reshape(-1, c)).reshape(b_l, -1, DIGEST_WORDS)
    # this rank's subtree root, then the top log2(sp) levels
    tops = _all_gather(_tree_tops(d), group, sp)  # [sp, B/dp, 8]
    return _tree_tops(tops.transpose(0, 1).contiguous())


def _phi(q_cols: torch.Tensor, counts: torch.Tensor, mesh):
    """(this rank's block of φ [B/dp, N/sp, 5], φ's last row [B/dp, 5])."""
    sp, r, group = axis_info(mesh, "sp")
    k = int(q_cols.shape[2])
    if k & (k - 1):
        # valida_tpu/parallel/mesh.py::logup_phi_step halves K with
        # `summed[:, :, :half] + summed[:, :, half:2*half]`, which drops the
        # odd column at every step (K = 3 never adds column 2)
        raise ValueError(f"logup_phi_step: K = {k} is not a power of two; "
                         f"the reference's pairwise sum drops columns there "
                         f"(ROADMAP C)")
    # the counts are raw u32 words, multiplied into Montgomery q as they are
    terms = ext_mul_base(q_cols, u32_as_int64(counts))  # [B/dp, N/sp, K, 5]
    while terms.shape[2] > 1:
        half = terms.shape[2] // 2
        terms = bb.add(terms[:, :, :half], terms[:, :, half:])
    local = terms[:, :, 0].to(torch.int64).cumsum(dim=1) % bb.P
    totals = _all_gather(local[:, -1], group, sp)  # [sp, B/dp, 5]
    below = totals[:r].sum(dim=0) % bb.P
    phi = ((local + below[:, None]) % bb.P).to(torch.int32)
    return phi, (totals.sum(dim=0) % bb.P).to(torch.int32)


def logup_phi_step(q_cols: torch.Tensor, counts: torch.Tensor,
                   mesh) -> torch.Tensor:
    """LogUp running sum of this rank's block: q [B/dp, N/sp, K, 5]
    Montgomery, counts [B/dp, N/sp, K] raw words -> this rank's block
    [B/dp, N/sp, 5] of φ = the prefix sum over rows of Σ_k q_k·count_k
    (mod p).  K must be a power of two."""
    return _phi(q_cols, counts, mesh)[0]


def full_prove_step(traces, q_cols, counts, mesh):
    """Commit and LogUp scan of this rank's blocks -> (roots [B/dp, 8],
    φ's last row [B/dp, 5]), both on every "sp" rank."""
    return commit_step(traces, mesh), _phi(q_cols, counts, mesh)[1]


def sharded_prove_fn(mesh):
    """fn(traces [B, N, C], q_cols [B, N, K, 5], counts [B, N, K]) on the
    global arrays (tensors, or u32 numpy arrays), which every rank holds
    alike: each rank takes its block (batch over "dp", rows over "sp") and
    every rank gets the global (roots [B, 8], phi_last [B, 5])."""
    dp, i, dp_group = axis_info(mesh, "dp")
    sp, j, _ = axis_info(mesh, "sp")
    dev = torch.device(mesh.device_type)

    def block(x, b_l, n_l):
        x = x[i * b_l:(i + 1) * b_l, j * n_l:(j + 1) * n_l]
        if isinstance(x, torch.Tensor):
            return x.to(dev).contiguous()
        return from_reference(np.ascontiguousarray(x), dev)

    def fn(traces, q_cols, counts):
        b, n = int(traces.shape[0]), int(traces.shape[1])
        if b % dp or n % sp:
            raise ValueError(f"{b} traces of {n} rows over a ({dp}, {sp}) "
                             f"mesh")
        local = [block(x, b // dp, n // sp) for x in (traces, q_cols, counts)]
        roots, phi_last = full_prove_step(*local, mesh)
        return (_all_gather(roots, dp_group, dp).reshape(b, DIGEST_WORDS),
                _all_gather(phi_last, dp_group, dp).reshape(b, -1))

    return fn
