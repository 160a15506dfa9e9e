"""Mixed-height Merkle tree root with Keccak-256.

Counterpart of the tree building in valida_tpu/crypto/merkle.py
(MerkleTree, l.57-103) and of valida_tpu/machine/jit_prover.py's device
forest (_build_levels, l.55-73).  Matrices whose power-of-two heights
differ are injected at the level matching their height:

  level log_max:  d(i) = H(rows of all max-height matrices at i)
  level k < max:  d(i) = C(d(2i), d(2i+1))
                  then, if matrices of height 2^k exist:
                  d(i) = C(d(i), H(rows at i))

H = Keccak-256 of the LE u32 word stream, C = Keccak-256 of 16 words.
Openings and their verification come with the PCS.
"""

from __future__ import annotations

import torch

from .keccak import keccak256_words

DIGEST_WORDS = 8


def hash_rows(mats: list) -> torch.Tensor:
    """mats: int32 [n, w_i] canonical -> [n, 8] digests of the
    concatenated rows."""
    return keccak256_words(torch.cat(mats, dim=1).contiguous())


def compress_pairs(d: torch.Tensor) -> torch.Tensor:
    """[n, 8] -> [n/2, 8]: C(d[2i], d[2i+1]).  Row i of the [n/2, 16] view
    is concat(d[2i], d[2i+1]), so no copy is made."""
    return keccak256_words(d.reshape(-1, 2 * DIGEST_WORDS))


def merkle_levels(mats: list) -> tuple[torch.Tensor, dict]:
    """mats: int32 canonical [h_i, w_i], h_i powers of two ->
    (root [8], {level k: digests [2^k, 8]})."""
    by_level: dict = {}
    for m in mats:
        h = int(m.shape[0])
        if h & (h - 1):
            raise ValueError(f"matrix height {h} is not a power of two")
        by_level.setdefault(h.bit_length() - 1, []).append(m)
    k = max(by_level)
    d = hash_rows(by_level[k])
    levels = {k: d}
    while k > 0:
        k -= 1
        d = compress_pairs(d)
        if k in by_level:
            inj = hash_rows(by_level[k])
            d = keccak256_words(torch.cat([d, inj], dim=1))
        levels[k] = d
    return levels[0][0], levels
