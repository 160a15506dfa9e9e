"""What the metrics of the Merkle trees read: the least time an H100
needs for a prove's trees, from the configuration's frozen shapes and its
profile alone, and the device-busy time inside the program's ranges
"merkle: <tree>".  Nothing here imports the program under test.

A prove builds the trees of its four commits (preprocessed, main,
permutation and quotient-chunk traces, each over the LDEs of its
matrices) and one tree a FRI commit-phase layer (the layer's pair matrix,
2^(log m - 1) rows of two extension values), with the hasher the profile
names.  The bound is roofline.py's: the larger of issue slots over the
card's 32-bit integer peak and bytes over its memory bandwidth, each LDE
word read once and each digest written once.  Keccak-f as roofline.py
counts it (4,320 slots a permutation, 34-word rate); Poseidon2 as
chip_smoke.py counts the `poseidon2` kernel's slots (3,150 a permutation,
8-word rate).  A row of w words takes as many permutations as the
hasher's sponge absorbs blocks of it; a compression hashes 16 words; a
level that holds matrices of its height hashes their rows, then hashes
each digest with that row's (16 words again)."""

from __future__ import annotations

import roofline

PREFIX = "merkle: "
PAIR_WORDS = 10  # a FRI layer's row: two extension values, base-flattened
COMPRESS_WORDS = 2 * roofline.DIGEST_BYTES // roofline.WORD

# issue slots of one Poseidon2 permutation (width 16, 8 external and 13
# internal rounds, x^7) with its block's absorption, as chip_smoke.py
# counts them: 8 x 16 x 4 + 13 x (4 + 16) products and 8 to absorb;
# 9 x 72 + 8 x 16 + 13 x (1 + 15 + 16) additions and 8 to absorb.  A
# product is 3 multiplies and 2 others, an addition 2 others; the two
# units share the others, so the larger of the multiplies and half of all
POSEIDON2_PRODUCTS = 8 * 16 * 4 + 13 * (4 + 16) + 8
POSEIDON2_ADDITIONS = 9 * 72 + 8 * 16 + 13 * (1 + 15 + 16) + 8
POSEIDON2_F_OPS = max(3 * POSEIDON2_PRODUCTS,
                      (5 * POSEIDON2_PRODUCTS + 2 * POSEIDON2_ADDITIONS) / 2)
POSEIDON2_RATE_WORDS = 8

# hasher -> (permutations of one message of w words, slots a permutation)
HASHERS = {
    "keccak": (lambda w: w // roofline.KECCAK_RATE_WORDS + 1,
               roofline.KECCAK_F_OPS),
    "poseidon2": (lambda w: -(-w // POSEIDON2_RATE_WORDS), POSEIDON2_F_OPS),
}


def tree_permutations(mats: list, hasher: str) -> int:
    """Permutations of the mixed-height Merkle tree of the matrices [(log
    height, width)]: each row of the tallest is hashed; each level below
    compresses pairs, and where matrices of that height exist, hashes
    their rows and compresses them in."""
    blocks, _ops = HASHERS[hasher]
    by_level: dict = {}
    for lh, w in mats:
        by_level[lh] = by_level.get(lh, 0) + w
    top = max(by_level)
    perms = (1 << top) * blocks(by_level[top])
    for k in range(top - 1, -1, -1):
        perms += (1 << k) * blocks(COMPRESS_WORDS)
        if k in by_level:
            perms += (1 << k) * (blocks(by_level[k]) + blocks(COMPRESS_WORDS))
    return perms


def prove_trees(size: dict, log_blowup: int) -> list:
    """The trees of a prove, each a list of (log height, width): the four
    commits' LDEs, then the FRI layers' pair matrices, from the tallest
    LDE down to the layer of 2^log_blowup values, where the folding stops
    (log_final 0: every profile of the benchmark folds to a constant)."""
    trees = [[(lh + log_blowup, w) for lh, w in mats]
             for mats in roofline.commit_rounds(size) if mats]
    log_max = max(lh for mats in trees for lh, _w in mats)
    trees += [[(log_m - 1, PAIR_WORDS)]
              for log_m in range(log_max, log_blowup, -1)]
    return trees


def bound(size: dict, profile: dict) -> tuple[float, str]:
    """(least seconds, "operations" or "bytes") of a prove's trees."""
    _blocks, f_ops = HASHERS[profile["hasher"]]
    ops = nbytes = 0.0
    for mats in prove_trees(size, int(profile["log_blowup"])):
        ops += tree_permutations(mats, profile["hasher"]) * f_ops
        top = max(lh for lh, _w in mats)
        nbytes += roofline.WORD * sum(w << lh for lh, w in mats)
        nbytes += roofline.DIGEST_BYTES * ((2 << top) - 1)
    return roofline.bound(ops, nbytes)


def busy_s(ctx) -> float | None:
    """Device-busy seconds over the traced proves inside the device ranges
    "merkle: <tree>"; None where the trace holds none of them."""
    if ctx.trace is None or not ctx.jobs:
        return None
    names = {n for _s, _e, n in ctx.trace.device_ranges
             if n.startswith(PREFIX)}
    return ctx.trace.busy_in(names) if names else None
