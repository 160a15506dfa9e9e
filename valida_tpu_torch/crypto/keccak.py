"""Keccak-256 (original pad 0x01) of u32-word messages, batched.

Counterpart of valida_tpu/crypto/keccak.py: messages are streams of u32
words serialized little-endian; digests are 8 u32 words (the little-endian
bytes of the 32-byte hash).  Words and digests are int32 tensors holding
the u32 bit patterns.

`keccak256_words` runs the CUDA kernel csrc/keccak.cu (replacing
keccak._keccak_pallas) on a CUDA tensor, for every batch size, and the
plain version below on a CPU tensor.  The plain version keeps the 25 lanes
as native 64-bit values (int64 bit patterns), where the reference splits
each into (lo, hi) u32 halves because the TPU has no u64.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..convert import to_int32_bits, u32_as_int64

RATE_WORDS = 34  # u32 words per block (136 bytes)
DIGEST_WORDS = 8

_RC64 = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# the same constants as int64 bit patterns
_RC_I64 = [c - (1 << 64) if c >> 63 else c for c in _RC64]

# rho rotation offsets, indexed by lane = x + 5*y
_RHO = [0] * 25
_x, _y = 1, 0
for _t in range(24):
    _RHO[_x + 5 * _y] = ((_t + 1) * (_t + 2) // 2) % 64
    _x, _y = _y, (2 * _x + 3 * _y) % 5

# pi: lane src = x + 5y moves to dst = y + 5*((2x + 3y) % 5)
_PI_DST = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_DST[_x + 5 * _y] = _y + 5 * ((2 * _x + 3 * _y) % 5)


def _pad_words(n_words: int) -> tuple[int, np.ndarray]:
    """(n_blocks, pad): the padding XORed onto the zero-extended words."""
    n_blocks = n_words // RATE_WORDS + 1
    total = n_blocks * RATE_WORDS
    pad = np.zeros(total, dtype=np.uint32)
    pad[n_words] ^= 0x01  # first padding byte (LE byte 0 of the word)
    pad[total - 1] ^= 0x80000000  # final 0x80 at the last byte
    return n_blocks, pad


# ---------------------------------------------------------------------------
# Plain PyTorch version: 25 int64 lane tensors
# ---------------------------------------------------------------------------


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    """64-bit rotate-left of int64 bit patterns (>> is arithmetic, so the
    bits shifted in from the top are masked)."""
    if r == 0:
        return v
    return (v << r) | ((v >> (64 - r)) & ((1 << r) - 1))


def keccak_f(lanes: list) -> list:
    """Keccak-f[1600] on a list of 25 int64 tensors (lane = x + 5*y)."""
    a = list(lanes)
    for rnd in range(24):
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [None] * 25
        for src in range(25):
            b[_PI_DST[src]] = _rotl(a[src], _RHO[src])
        a = [b[i] ^ (~b[i - i % 5 + (i + 1) % 5] & b[i - i % 5 + (i + 2) % 5])
             for i in range(25)]
        a[0] = a[0] ^ _RC_I64[rnd]
    return a


def keccak256_words_plain(words: torch.Tensor) -> torch.Tensor:
    """words: int32 [batch, n_words] -> int32 [batch, 8] digests."""
    batch, n_words = words.shape
    n_blocks, pad = _pad_words(n_words)
    total = n_blocks * RATE_WORDS
    buf = torch.zeros(batch, total, dtype=torch.int64, device=words.device)
    buf[:, :n_words] = u32_as_int64(words)
    buf ^= torch.from_numpy(pad.astype(np.int64)).to(words.device)
    lanes = [torch.zeros(batch, dtype=torch.int64, device=words.device)
             for _ in range(25)]
    for blk in range(n_blocks):
        base = blk * RATE_WORDS
        for k in range(17):
            lanes[k] = lanes[k] ^ (buf[:, base + 2 * k]
                                   | (buf[:, base + 2 * k + 1] << 32))
        lanes = keccak_f(lanes)
    out = []
    for k in range(4):
        out += [lanes[k] & 0xFFFFFFFF, (lanes[k] >> 32) & 0xFFFFFFFF]
    return to_int32_bits(torch.stack(out, dim=1))


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def keccak256_words(words: torch.Tensor) -> torch.Tensor:
    """Batched Keccak-256: int32 [batch, n_words] -> int32 [batch, 8]."""
    if words.device.type == "cpu":
        return keccak256_words_plain(words)
    batch, n_words = words.shape
    _build.check_input(words, "keccak256 words")
    out = torch.empty(batch, DIGEST_WORDS, dtype=torch.int32,
                      device=words.device)
    _build.launch("keccak", "keccak256_launch", words, out, batch, n_words)
    _build.LAUNCHES["keccak256"] += 1
    return out


# ---------------------------------------------------------------------------
# Host (python int) mirror
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def _h_rotl(v: int, r: int) -> int:
    r %= 64
    return ((v << r) | (v >> (64 - r))) & _M64


def keccak_f_host(lanes: list) -> list:
    a = list(lanes)
    for rnd in range(24):
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _h_rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [0] * 25
        for src in range(25):
            b[_PI_DST[src]] = _h_rotl(a[src], _RHO[src])
        a = [b[i] ^ ((~b[i - i % 5 + (i + 1) % 5] & _M64)
                     & b[i - i % 5 + (i + 2) % 5])
             for i in range(25)]
        a[0] ^= _RC64[rnd]
    return a


def keccak256_words_host(words) -> np.ndarray:
    """Host Keccak-256 of one u32-word message; returns uint32[8]."""
    words = [int(w) & 0xFFFFFFFF for w in words]
    n_blocks, pad = _pad_words(len(words))
    buf = [w ^ int(p) for w, p in
           zip(words + [0] * (len(pad) - len(words)), pad)]
    lanes = [0] * 25
    for blk in range(n_blocks):
        block = buf[blk * RATE_WORDS:(blk + 1) * RATE_WORDS]
        for k in range(17):
            lanes[k] ^= block[2 * k] | (block[2 * k + 1] << 32)
        lanes = keccak_f_host(lanes)
    out = []
    for lane in lanes[:4]:
        out += [lane & 0xFFFFFFFF, lane >> 32]
    return np.array(out, dtype=np.uint32)
