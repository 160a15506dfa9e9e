"""The coset LDE and its Merkle commit without the whole LDE in memory.

Counterpart of valida_tpu/commit/streamed.py.  The monolithic commit
(`poly/ntt.coset_lde`, then the tree) holds the [N·2^b, w] LDE, and the
plain elementwise passes around the NTT kernels widen it to int64 on top.
The blowup-b LDE is b coset NTTs of size N, and in the bit-reversed row
order the PCS hashes, each coset's rows form one contiguous block of
leaves:

    eval at shift·w_{bN}^k,  k = r + b·t
      = NTT_N(c_i · (shift·w_{bN}^r)^i)[t]
    bitrev_{bN}(k) = bitrev_b(r)·N + bitrev_N(t)

So block bitrev_b(r) of the bit-reversed LDE is `dif(c · powers(shift ·
w_{bN}^r))`: it is computed, hashed to [N, 8] digests and dropped before
the next block.  The tree is then built from the [bN, 8] digest matrix.
The words equal the monolithic tree's (exact field arithmetic, the same
hasher): tests/test_torch_streamed.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import from_reference, table, to_numpy
from ..crypto.merkle import compress_pairs, get_hasher
from ..device import resolve
from ..field import babybear as bb
from ..poly import ntt as nttm


def _rev_bits(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def lde_commit_streamed(evals, log_blowup: int, shift: int,
                        hasher="keccak", col_tile: int | None = None,
                        row_tile: int | None = None, device="cuda"):
    """Coset LDE and whole Merkle commit, one coset block at a time.

    evals: Montgomery int32 [N, w] (a tensor, or a u32 numpy array), the
    evaluations on H_N; it runs on `device`, the card by default.
    Returns (root, levels): root, np.uint32[8], equals
    `MerkleTree([from_monty(coset_lde(evals, log_blowup, shift,
    out_bitrev=True))], hasher).root()`; levels = {log_h: [2^log_h, 8]}
    digest tensors on the device (the rows themselves are not kept).

    col_tile: transform the columns in tiles of this width (the
    coefficients and each block's transform are then held per tile).
    row_tile: hash the leaves and compress the digest levels in row tiles
    of this many rows, a power of two.  Rows hash independently, so the
    words do not change.

    Device memory at the peak: the caller's evals, the coefficients
    ([N, w] int32), one coset block ([N, w] int32), and the two int64
    temporaries of one plain elementwise pass over a block (the coset
    shift's product, then the conversion to canonical form before
    hashing), with the digests ([bN, 8] int32) beside them; never the
    [bN, w] LDE.
    """
    dev = resolve(device)
    if not isinstance(evals, torch.Tensor):
        evals = from_reference(np.asarray(evals))
    evals = evals.to(dev)
    hasher = get_hasher(hasher)
    n, w = int(evals.shape[0]), int(evals.shape[1])
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"evals height {n} is not a power of two")
    if row_tile and row_tile & (row_tile - 1):
        raise ValueError(f"row_tile {row_tile} is not a power of two")
    w_bn = bb.two_adic_generator(log_n + log_blowup)
    tiles = ([slice(0, w)] if not col_tile else
             [slice(i, min(i + col_tile, w)) for i in range(0, w, col_tile)])
    coeff_tiles = [nttm.intt(evals[:, t].contiguous()) for t in tiles]

    rt = row_tile if row_tile and row_tile < n else n

    def hash_rows(parts):
        cat = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        return hasher.hash_words(bb.from_monty(cat))

    digest_blocks: list = [None] * (1 << log_blowup)
    for r in range(1 << log_blowup):
        s_r = shift % bb.P * pow(w_bn, r, bb.P) % bb.P
        sp = table(nttm.shift_powers, s_r, log_n, device=dev)[:, None]
        parts = [nttm.dif(bb.mul(c, sp)) for c in coeff_tiles]
        digest_blocks[_rev_bits(r, log_blowup)] = torch.cat(
            [hash_rows([p[i:i + rt] for p in parts])
             for i in range(0, n, rt)])
        del parts
    del coeff_tiles

    k = log_n + log_blowup
    d = torch.cat(digest_blocks)
    del digest_blocks
    levels = {k: d}
    while k > 0:
        k -= 1
        m = 1 << k  # digests of this level
        if rt < m:
            d = torch.cat([compress_pairs(d[2 * j:2 * (j + rt)], hasher)
                           for j in range(0, m, rt)])
        else:
            d = compress_pairs(d, hasher)
        levels[k] = d
    return to_numpy(d[0]), levels
