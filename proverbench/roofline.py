"""The least time an H100 needs for a prove's quotient and its commits,
from the configuration's frozen shapes and counts alone, whatever code
does the work (copied from chip_smoke.py's arithmetic and frozen here).

A bound is the larger of issue slots over the card's 32-bit integer peak
and bytes over its memory bandwidth, and says which of the two it is.
Each input is read once and each output written once; tables an
implementation builds for itself are not counted."""

from __future__ import annotations

# H100 SXM (NVIDIA H100 data sheet): device memory 3.35 TB/s; 64 32-bit
# integer results per clock per SM (compute capability 9.0), 132 SMs, the
# maximum SM clock 1,980 MHz
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1980e6
WORD = 4  # bytes of a field word
DIGEST_BYTES = 32
# a radix-2 butterfly: 3 multiplies (the Montgomery product) and 5 others
# shared by two units: the larger of the multiplies and half of all
BUTTERFLY_OPS = max(3, (3 + 5) / 2)
# a Keccak-f permutation: 24 rounds of 180 32-bit instructions on 64-bit
# lanes kept as halves, 3-input logic fused
KECCAK_F_OPS = 24 * 180
KECCAK_RATE_WORDS = 34  # 136-byte rate of Keccak-256, in 32-bit words
EXT = 5  # degree of the extension field: a quotient value is 5 words


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _butterflies(log_n: int, cols: int) -> float:
    return (1 << log_n) / 2 * log_n * cols


def _keccak_blocks(words: int) -> int:
    """Keccak-f permutations of one message of `words` 32-bit words (the
    padding takes at least one byte)."""
    return words // KECCAK_RATE_WORDS + 1


def tree_permutations(mats: list) -> int:
    """Keccak-f permutations of the mixed-height Merkle tree of the
    matrices [(log height, width)]: each row of the tallest is hashed; each
    level below compresses pairs (16 words), and where matrices of that
    height exist, hashes their rows and compresses them in."""
    by_level: dict = {}
    for lh, w in mats:
        by_level[lh] = by_level.get(lh, 0) + w
    top = max(by_level)
    perms = (1 << top) * _keccak_blocks(by_level[top])
    for k in range(top - 1, -1, -1):
        perms += 1 << k
        if k in by_level:
            perms += (1 << k) * (_keccak_blocks(by_level[k]) + 1)
    return perms


def commit_work(mats: list, log_blowup: int) -> tuple[float, float]:
    """(issue slots, bytes) of committing the matrices [(log height,
    width)]: the inverse NTT, the coset NTT of the blown-up domain, the
    tree of the LDEs; reading the matrix, writing coefficients, LDE and
    the tree's digests."""
    ops = nbytes = 0.0
    ldes = []
    for lh, w in mats:
        ops += (_butterflies(lh, w) + _butterflies(lh + log_blowup, w)) \
            * BUTTERFLY_OPS
        h, lde = 1 << lh, 1 << (lh + log_blowup)
        nbytes += WORD * w * (h + h + lde)
        ldes.append((lh + log_blowup, w))
    ops += tree_permutations(ldes) * KECCAK_F_OPS
    top = max(lh for lh, _ in ldes)
    nbytes += DIGEST_BYTES * ((2 << top) - 1)
    return ops, nbytes


def commit_rounds(size: dict) -> list:
    """The four commitments of a prove, each a list of (log height,
    width): preprocessed, main, permutation and quotient-chunk traces."""
    chips = size["chips"].values()
    return [
        [(c["log_height"], c["prep_width"]) for c in chips if c["prep_width"]],
        [(c["log_height"], c["main_width"]) for c in chips],
        [(c["log_height"], c["perm_width"]) for c in chips],
        [(c["log_height"], EXT << c["log_qd"]) for c in chips],
    ]


def commit_bound(size: dict, log_blowup: int) -> tuple[float, str]:
    ops = nbytes = 0.0
    for mats in commit_rounds(size):
        if mats:
            o, b = commit_work(mats, log_blowup)
            ops, nbytes = ops + o, nbytes + b
    return bound(ops, nbytes)


def quotient_bound(size: dict) -> tuple[float, str]:
    """Each chip's constraints on every row of its quotient domain (Q =
    2^(log height + log_qd) rows; `quotient_slots` a row, frozen from its
    constraint system), then the quotient's split into 2^log_qd chunks
    (an inverse NTT of the [Q, 5] values, a coset NTT of the chunks);
    bytes: the LDE rows read once, the chunk matrix written once."""
    ops = nbytes = 0.0
    for c in size["chips"].values():
        lh, qd = c["log_height"], c["log_qd"]
        q = 1 << (lh + qd)
        ops += q * c["quotient_slots"]
        ops += (_butterflies(lh + qd, EXT)
                + _butterflies(lh, EXT << qd)) * BUTTERFLY_OPS
        nbytes += WORD * q * (c["main_width"] + c["perm_width"]
                              + c["prep_width"] + EXT)
    return bound(ops, nbytes)
