"""The trace commit: coset LDE + Keccak Merkle root.

`commit_forward` is `__graft_entry__.entry()`'s forward step: trace to
Montgomery form, coset LDE (blowup 2, shift = the generator, bit-reversed
output), back to canonical form, Keccak-256 leaf hashing, then pairwise
compression up to one 8-word root.  `commit_matrices` gives the root of
the LDE + Merkle part of the reference's TwoAdicFriPcs.commit_batches
(commit/pcs.py, for evaluation domains with no shift).

Both take numpy u32 arrays or int32 tensors and run on `device`, the card
by default; with no GPU they raise rather than run on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import from_reference
from ..crypto.keccak import keccak256_words
from ..crypto.merkle import compress_pairs, merkle_levels
from ..device import resolve
from ..field import babybear as bb
from ..poly import ntt as nttm


def _on(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return from_reference(np.asarray(x), dev)


def commit_forward(trace, device="cuda") -> torch.Tensor:
    """trace: canonical u32 [2^k, w] -> Merkle root, int32 [8]."""
    dev = resolve(device)
    m = bb.to_monty(_on(trace, dev))
    lde = nttm.coset_lde(m, 1, bb.GENERATOR, out_bitrev=True)
    digests = keccak256_words(bb.from_monty(lde))
    while digests.shape[0] > 1:
        digests = compress_pairs(digests)
    return digests[0]


def commit_matrices(mats, log_blowup: int = 1, shift: int = bb.GENERATOR,
                    device="cuda") -> torch.Tensor:
    """mats: canonical u32 [h_i, w_i] evaluations over H_{h_i} -> root of
    the mixed-height tree over their bit-reversed coset LDEs, int32 [8]."""
    dev = resolve(device)
    committed = [
        bb.from_monty(nttm.coset_lde(bb.to_monty(_on(mat, dev)), log_blowup,
                                     shift % bb.P, out_bitrev=True))
        for mat in mats
    ]
    root, _ = merkle_levels(committed)
    return root
