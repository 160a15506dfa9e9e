"""Mixed-height batched Merkle tree commitment (MMCS).

Counterpart of valida_tpu/crypto/merkle.py.  Matrices whose power-of-two
heights differ are injected at the level matching their height:

  level log_max:  d(i) = H(rows of all max-height matrices at i)
  level k < max:  d(i) = C(d(2i), d(2i+1))
                  then, if matrices of height 2^k exist:
                  d(i) = C(d(i), H(rows at i))

H hashes the u32 word stream of a row, C hashes 16 words; the hasher is
Keccak-256 or the Poseidon2 sponge, both with 8-word digests.  Trees are
built on the matrices' device, one hash call per level; openings are
gathered on the device and copied to the host once per tree; path
verification runs on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import from_reference, to_numpy
from .keccak import (keccak256_words, keccak256_words_host,
                     keccak256_words_numpy)

DIGEST_WORDS = 8


class Hasher:
    """Digest hasher of the MMCS: `hash_words` on int32 [n, w] tensors (the
    kernel on a CUDA tensor, the plain version on a CPU tensor),
    `hash_words_host` on one message, and `hash_numpy` on u32 [n, w]
    numpy arrays (the verifier's batched path checks): a host version of
    its own where given, else the plain version on CPU tensors."""

    def __init__(self, name, hash_words, hash_words_host, hash_numpy=None):
        self.name = name
        self.hash_words = hash_words
        self.hash_words_host = hash_words_host
        self._hash_numpy = hash_numpy

    def hash_numpy(self, words: np.ndarray) -> np.ndarray:
        """u32 [n, w] on the host -> u32 [n, 8]."""
        if self._hash_numpy is not None:
            return self._hash_numpy(words)
        return to_numpy(self.hash_words(from_reference(words)))


KECCAK = Hasher("keccak", keccak256_words, keccak256_words_host,
                keccak256_words_numpy)


def _poseidon2_hasher():
    from . import poseidon2 as p2

    return Hasher("poseidon2", p2.hash_words, p2.hash_words_host)


_HASHERS = {"keccak": lambda: KECCAK, "poseidon2": _poseidon2_hasher}


def get_hasher(name) -> Hasher:
    if isinstance(name, Hasher):
        return name
    return _HASHERS[name]()


def hash_rows(mats: list, hasher=KECCAK) -> torch.Tensor:
    """mats: int32 [n, w_i] canonical -> [n, 8] digests of the
    concatenated rows."""
    cat = mats[0] if len(mats) == 1 else torch.cat(mats, dim=1)
    return get_hasher(hasher).hash_words(cat.contiguous())


def compress_pairs(d: torch.Tensor, hasher=KECCAK) -> torch.Tensor:
    """[n, 8] -> [n/2, 8]: C(d[2i], d[2i+1]).  Row i of the [n/2, 16] view
    is concat(d[2i], d[2i+1]), so no copy is made."""
    return get_hasher(hasher).hash_words(d.reshape(-1, 2 * DIGEST_WORDS))


def _log_height(m) -> int:
    h = int(m.shape[0])
    if h & (h - 1) or h == 0:
        raise ValueError(f"matrix height {h} is not a power of two")
    return h.bit_length() - 1


def merkle_levels(mats: list, hasher=KECCAK,
                  low: int = 0) -> tuple[torch.Tensor, dict]:
    """mats: int32 canonical [h_i, w_i], h_i powers of two ->
    (the first digest of the lowest level built, {level k: digests [2^k,
    8]}) for k from the tallest matrix's log height down to `low` (the
    root and every level where low is 0)."""
    hasher = get_hasher(hasher)
    by_level: dict = {}
    for m in mats:
        by_level.setdefault(_log_height(m), []).append(m)
    k = max(by_level)
    d = hash_rows(by_level[k], hasher)
    levels = {k: d}
    while k > low:
        k -= 1
        d = compress_pairs(d, hasher)
        if k in by_level:
            inj = hash_rows(by_level[k], hasher)
            d = hasher.hash_words(torch.cat([d, inj], dim=1))
        levels[k] = d
    return d[0], levels


class MerkleTree:
    def __init__(self, matrices, hasher=KECCAK):
        """matrices: int32 tensors [h_i, w_i] of canonical values on one
        device, h_i powers of two.  Their order is kept for openings."""
        self.hasher = get_hasher(hasher)
        self.matrices = list(matrices)
        self.log_max = max(_log_height(m) for m in self.matrices)
        self.root_tensor, self.levels = merkle_levels(self.matrices,
                                                      self.hasher)
        self.root_array = to_numpy(self.root_tensor)

    def root(self) -> np.ndarray:
        """The commitment, np.uint32 [8]."""
        return self.root_array

    def open(self, index: int):
        """Open leaf `index` in [0, 2^log_max): (opened_rows, path), where
        opened_rows[i] is the row of matrix i at index >> (log_max -
        log_h_i) and path holds the sibling digests from level log_max down
        to 1, all np.uint32."""
        return self.open_many([index])[0]

    def open_many(self, indices):
        """`open` for every index: one gather per matrix and level on the
        device, then one copy to the host for all queries."""
        q = len(indices)
        if q == 0:
            return []
        dev = self.matrices[0].device
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=dev)
        pieces, widths = [], []
        for m in self.matrices:
            pieces.append(m[idx >> (self.log_max - _log_height(m))])
            widths.append(int(m.shape[1]))
        lvl = idx
        for k in range(self.log_max, 0, -1):
            pieces.append(self.levels[k][lvl ^ 1])
            lvl = lvl >> 1
        host = to_numpy(torch.cat(pieces, dim=1))  # the single copy
        out = []
        for qi in range(q):
            off = 0
            rows = []
            for w in widths:
                rows.append(host[qi, off:off + w].copy())
                off += w
            path = []
            for _ in range(self.log_max):
                path.append(host[qi, off:off + DIGEST_WORDS].copy())
                off += DIGEST_WORDS
            out.append((rows, path))
        return out


def verify_openings(root, dims, indices, opened_rows, paths,
                    hasher=KECCAK) -> bool:
    """Host-side path verification of all queries of one tree, one batched
    hash per level.

    dims: (height, width) per matrix; indices: int array [q];
    opened_rows[mi]: u32 [q, w_mi]; paths: u32 [q, log_max, 8] sibling
    digests leaf to root.  True iff every query's recomputed root equals
    `root`."""
    hasher = get_hasher(hasher)
    log_max = max(int(h).bit_length() - 1 for h, _ in dims)
    idx = np.array(indices, dtype=np.int64, copy=True)
    paths = np.asarray(paths, dtype=np.uint32)
    by_level: dict = {}
    for (h, _w), rows in zip(dims, opened_rows):
        k = int(h).bit_length() - 1
        by_level.setdefault(k, []).append(np.asarray(rows, dtype=np.uint32))

    def h_rows(k):
        return hasher.hash_numpy(np.concatenate(by_level[k], axis=1))

    def c(a, b):
        return hasher.hash_numpy(np.concatenate([a, b], axis=1))

    d = h_rows(log_max)
    for step, k in enumerate(range(log_max, 0, -1)):
        sib = paths[:, step]
        odd = (idx & 1).astype(bool)[:, None]
        d = c(np.where(odd, sib, d), np.where(odd, d, sib))
        idx >>= 1
        if (k - 1) in by_level:
            d = c(d, h_rows(k - 1))
    return bool(np.array_equal(d, np.broadcast_to(
        np.asarray(root, dtype=np.uint32), d.shape)))


def verify_opening(root, dims, index: int, opened_rows, path,
                   hasher=KECCAK) -> bool:
    """Host-side path verification of one query, on one message at a time.

    dims: (height, width) per matrix; opened_rows: one u32 row per matrix;
    path: sibling digests leaf to root."""
    hasher = get_hasher(hasher)
    log_max = max(int(h).bit_length() - 1 for h, _ in dims)
    by_level: dict = {}
    for (h, _w), row in zip(dims, opened_rows):
        by_level.setdefault(int(h).bit_length() - 1, []).append(row)

    def h_rows(k):
        return hasher.hash_words_host(np.concatenate(
            [np.asarray(r, dtype=np.uint32) for r in by_level[k]]))

    def c(a, b):
        return hasher.hash_words_host(list(a) + list(b))

    d = h_rows(log_max)
    idx = index
    for step, k in enumerate(range(log_max, 0, -1)):
        sib = path[step]
        d = c(sib, d) if idx & 1 else c(d, sib)
        idx >>= 1
        if (k - 1) in by_level:
            d = c(d, h_rows(k - 1))
    return bool(np.array_equal(np.asarray(d), np.asarray(root)))
