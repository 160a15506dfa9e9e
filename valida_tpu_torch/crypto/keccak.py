"""Keccak-256 (original pad 0x01) of u32-word messages, batched.

Counterpart of valida_tpu/crypto/keccak.py: messages are streams of u32
words serialized little-endian; digests are 8 u32 words (the little-endian
bytes of the 32-byte hash).  Words and digests are int32 tensors holding
the u32 bit patterns.

`keccak256_words` runs the CUDA kernel csrc/keccak.cu (replacing
keccak._keccak_pallas) on a CUDA tensor, for every batch size, and the
plain version below on a CPU tensor.  The plain version keeps the 25 lanes
as native 64-bit values (int64 bit patterns), where the reference splits
each into (lo, hi) u32 halves because the TPU has no u64; so does the host
version `keccak256_words_numpy` (numpy uint64 lanes), which the verifier's
Merkle path checks use.
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
# Plain PyTorch version: the state as one [25, batch] int64 tensor
# ---------------------------------------------------------------------------
#
# Each step of a round is a few operations on the whole state: theta's
# column parities and chi's neighbours are gathers along the lane axis,
# rho is one shift by a per-lane amount, pi one gather.  A logical right
# shift by 64 - r is ((v >> 1) & (2^63 - 1)) >> (63 - r), which needs no
# shift by 64 when r = 0 (>> is arithmetic on int64).

_LANES = np.arange(25)
_COL = _LANES % 5
# theta: C[x] = xor over y of A[x + 5y]; D[x] = C[x-1] ^ rotl(C[x+1], 1)
_THETA_M1 = (np.arange(5) - 1) % 5
_THETA_P1 = (np.arange(5) + 1) % 5
_PI_SRC = np.zeros(25, dtype=np.int64)  # B[dst] = rotl(A[src], rho[src])
for _src in range(25):
    _PI_SRC[_PI_DST[_src]] = _src
_RHO_AT_DST = np.array(_RHO)[_PI_SRC]
# chi: A'[i] = B[i] ^ (~B[x+1 of i's row] & B[x+2 of i's row])
_CHI_1 = _LANES - _COL + (_COL + 1) % 5
_CHI_2 = _LANES - _COL + (_COL + 2) % 5
_M63 = (1 << 63) - 1


def _torch_tables(device):
    t = {k: torch.as_tensor(v, dtype=torch.int64, device=device)
         for k, v in (("theta_m1", _THETA_M1), ("theta_p1", _THETA_P1),
                      ("col", _COL), ("pi", _PI_SRC), ("chi1", _CHI_1),
                      ("chi2", _CHI_2), ("rc", _RC_I64))}
    t["rho"] = torch.as_tensor(_RHO_AT_DST, dtype=torch.int64,
                               device=device)[:, None]
    return t


def keccak_f(lanes: list) -> list:
    """Keccak-f[1600] on a list of 25 int64 tensors (lane = x + 5*y)."""
    return list(keccak_f_state(torch.stack(lanes)).unbind(0))


def keccak_f_state(state: torch.Tensor, tables=None) -> torch.Tensor:
    """Keccak-f[1600] on a [25, batch] int64 state (lane = x + 5*y)."""
    t = tables or _torch_tables(state.device)
    a = state
    for rnd in range(24):
        c = a[0:5] ^ a[5:10] ^ a[10:15] ^ a[15:20] ^ a[20:25]
        c1 = c[t["theta_p1"]]
        d = c[t["theta_m1"]] ^ ((c1 << 1) | ((c1 >> 63) & 1))
        a = a ^ d[t["col"]]
        b = a[t["pi"]]
        b = (b << t["rho"]) | (((b >> 1) & _M63) >> (63 - t["rho"]))
        a = b ^ (~b[t["chi1"]] & b[t["chi2"]])
        a[0] ^= t["rc"][rnd]
    return a


def keccak256_words_plain(words: torch.Tensor) -> torch.Tensor:
    """words: int32 [batch, n_words] -> int32 [batch, 8] digests."""
    batch, n_words = words.shape
    n_blocks, pad = _pad_words(n_words)
    total = n_blocks * RATE_WORDS
    dev = words.device
    buf = torch.zeros(batch, total, dtype=torch.int64, device=dev)
    buf[:, :n_words] = u32_as_int64(words)
    buf ^= torch.from_numpy(pad.astype(np.int64)).to(dev)
    # lanes of each block: word 2k | word 2k+1 << 32, as [blocks, 17, batch]
    blocks = buf.view(batch, n_blocks, 17, 2)
    blocks = (blocks[..., 0] | (blocks[..., 1] << 32)).permute(1, 2, 0)
    tables = _torch_tables(dev)
    state = torch.zeros(25, batch, dtype=torch.int64, device=dev)
    for blk in range(n_blocks):
        state[:17] ^= blocks[blk]
        state = keccak_f_state(state, tables)
    out = torch.stack([state[:4] & 0xFFFFFFFF, (state[:4] >> 32) & 0xFFFFFFFF],
                      dim=2)  # [4, batch, 2]
    return to_int32_bits(out.permute(1, 0, 2).reshape(batch, 8))


# ---------------------------------------------------------------------------
# Host version for the verifier: numpy uint64 lanes, vectorised over the
# batch in the same [25, batch] layout
# ---------------------------------------------------------------------------

_RC_U64 = np.array(_RC64, dtype=np.uint64)
_RHO_U64 = _RHO_AT_DST.astype(np.uint64)[:, None]
_RHO_INV_U64 = (63 - _RHO_AT_DST).astype(np.uint64)[:, None]


def keccak_f_numpy(a: np.ndarray) -> np.ndarray:
    """Keccak-f[1600] on a [25, batch] uint64 state."""
    one, s63 = np.uint64(1), np.uint64(63)
    for rnd in range(24):
        c = a[0:5] ^ a[5:10] ^ a[10:15] ^ a[15:20] ^ a[20:25]
        c1 = c[_THETA_P1]
        d = c[_THETA_M1] ^ ((c1 << one) | (c1 >> s63))
        a = a ^ d[_COL]
        b = a[_PI_SRC]
        b = (b << _RHO_U64) | ((b >> one) >> _RHO_INV_U64)
        a = b ^ (~b[_CHI_1] & b[_CHI_2])
        a[0] ^= _RC_U64[rnd]
    return a


def keccak256_words_numpy(words: np.ndarray) -> np.ndarray:
    """u32 [batch, n_words] on the host -> u32 [batch, 8] digests; the
    same words as keccak256_words_plain."""
    words = np.asarray(words, dtype=np.uint32)
    batch, n_words = words.shape
    n_blocks, pad = _pad_words(n_words)
    buf = np.zeros((batch, n_blocks * RATE_WORDS), dtype=np.uint32)
    buf[:, :n_words] = words
    buf ^= pad
    # little-endian u32 pairs are the u64 lanes: [blocks, 17, batch]
    lanes = np.ascontiguousarray(buf).view("<u8").astype(np.uint64)
    lanes = lanes.reshape(batch, n_blocks, 17).transpose(1, 2, 0)
    state = np.zeros((25, batch), dtype=np.uint64)
    for blk in range(n_blocks):
        state[:17] ^= lanes[blk]
        state = keccak_f_numpy(state)
    return np.ascontiguousarray(state[:4].T).view(np.uint32).reshape(batch, 8)


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
    _build.count_launch("keccak256")
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
