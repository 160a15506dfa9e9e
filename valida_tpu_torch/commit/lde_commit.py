"""The trace commit: coset LDE + Merkle root.

`commit_forward` is `__graft_entry__.entry()`'s forward step: trace to
Montgomery form, coset LDE (blowup 2, shift = the generator, bit-reversed
output), back to canonical form, Keccak-256 leaf hashing, then pairwise
compression up to one 8-word root.  `commit_matrices` is the root of
`TwoAdicFriPcs.commit_batches` (commit/pcs.py), the one commit of
mixed-height matrices.

Both take numpy u32 arrays or int32 tensors and run on `device`, the card
by default; with no GPU they raise rather than run on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import from_reference
from ..crypto.keccak import keccak256_words
from ..crypto.merkle import compress_pairs
from ..device import resolve
from ..field import babybear as bb
from ..poly import ntt as nttm
from .fri import FriConfig
from .pcs import TwoAdicFriPcs


def commit_forward(trace, device="cuda") -> torch.Tensor:
    """trace: canonical u32 [2^k, w] -> Merkle root, int32 [8]."""
    dev = resolve(device)
    if not isinstance(trace, torch.Tensor):
        trace = from_reference(np.asarray(trace))
    m = bb.to_monty(trace.to(dev))
    lde = nttm.coset_lde(m, 1, bb.GENERATOR, out_bitrev=True)
    digests = keccak256_words(bb.from_monty(lde))
    while digests.shape[0] > 1:
        digests = compress_pairs(digests)
    return digests[0]


def commit_matrices(mats, log_blowup: int = 1, shift: int = bb.GENERATOR,
                    device="cuda", hasher="keccak",
                    domain_shifts=None) -> torch.Tensor:
    """mats: canonical u32 [h_i, w_i] evaluations over shift_i·H_{h_i} ->
    root of the mixed-height tree over their bit-reversed coset LDEs,
    int32 [8] on `device`."""
    pcs = TwoAdicFriPcs(FriConfig(log_blowup=log_blowup, hasher=hasher),
                        coset_shift=shift, device=device)
    _, data = pcs.commit_batches(mats, domain_shifts)
    return data.tree.root_tensor
