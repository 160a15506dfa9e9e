"""Poseidon2 over BabyBear, width 16, S-box x^7: the Merkle hasher of a
`hasher="poseidon2"` profile, as the frozen verifier reaches it.

The port's crypto/poseidon2.py cut to the constants, the permutation and
the sponge on CPU tensors (`hash_words`, `hash_words_host`):
  * 8 external rounds (4 + 4) with the block-circulant matrix
    circ(2·M4, M4, M4, M4), M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]];
  * 13 internal rounds: S-box on lane 0, then x -> sum(x)·1 + diag(d)·x;
  * round constants and the diagonal from a SHA-256 expansion of a fixed
    seed;
  * a sponge of rate 8 and capacity 8 over u32 words taken mod p; a digest
    is 8 canonical field words.
Where the port's plain version keeps the state in Montgomery form in int32
tensors, this one keeps canonical words in numpy uint64 (a product of two
words below p fits in 62 bits) and reduces each sum and product mod p: the
same permutation of the field, in a form that shares no arithmetic with
the code under test and judges a proof's 100 queries in milliseconds a
level.  A CUDA tensor is an error: the reference runs on the CPU only.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import _build
from ..field.babybear import P

WIDTH = 16
RATE = 8
EXTERNAL_ROUNDS = 8  # 4 + 4
INTERNAL_ROUNDS = 13

_SEED = b"validia seed/poseidon2"
_P = np.uint64(P)


def _expand(n: int, tag: bytes) -> list[int]:
    out = []
    counter = 0
    while len(out) < n:
        digest = hashlib.sha256(
            _SEED + tag + counter.to_bytes(8, "little")).digest()
        counter += 1
        for i in range(0, 32, 4):
            word = int.from_bytes(digest[i:i + 4], "little")
            if word < 2 * P:  # rejection removes the bias of the mod
                out.append(word % P)
                if len(out) == n:
                    break
    return out


EXTERNAL_CONSTANTS = np.array(
    _expand(EXTERNAL_ROUNDS * WIDTH, b"/ext"), dtype=np.uint64
).reshape(EXTERNAL_ROUNDS, WIDTH)
INTERNAL_CONSTANTS = np.array(_expand(INTERNAL_ROUNDS, b"/int"),
                              dtype=np.uint64)
INTERNAL_DIAG = np.array(_expand(WIDTH, b"/diag"), dtype=np.uint64)


def _sbox7(x: np.ndarray) -> np.ndarray:
    x2 = x * x % _P
    x4 = x2 * x2 % _P
    return x4 * x2 % _P * x % _P


def _external_linear(state: np.ndarray) -> np.ndarray:
    """circ(2·M4, M4, M4, M4) on [n, 16]: M4 on each block of four lanes,
    then every lane gains the sum over the blocks (sums below 2^36, reduced
    once)."""
    s4 = state.reshape(-1, 4, 4)
    x0, x1, x2, x3 = (s4[..., i] for i in range(4))
    t = x0 + x1 + x2 + x3
    m4 = np.stack([t + x0 + 2 * x1, t + x1 + 2 * x2, t + x2 + 2 * x3,
                   t + x3 + 2 * x0], axis=-1)  # [n, block, lane]
    return ((m4 + m4.sum(axis=1, keepdims=True)) % _P).reshape(-1, WIDTH)


def permute(state: np.ndarray) -> np.ndarray:
    """Poseidon2 permutation: canonical uint64 [n, 16] -> the same."""
    state = _external_linear(state)
    half = EXTERNAL_ROUNDS // 2
    for r in range(half):
        state = _external_linear(_sbox7((state + EXTERNAL_CONSTANTS[r]) % _P))
    for r in range(INTERNAL_ROUNDS):
        state = state.copy()
        state[:, 0] = _sbox7((state[:, 0] + INTERNAL_CONSTANTS[r]) % _P)
        total = state.sum(axis=1, keepdims=True) % _P
        state = (state * INTERNAL_DIAG + total) % _P
    for r in range(half, EXTERNAL_ROUNDS):
        state = _external_linear(_sbox7((state + EXTERNAL_CONSTANTS[r]) % _P))
    return state


def hash_numpy(words: np.ndarray) -> np.ndarray:
    """Sponge hash of u32-word rows: uint32 [n, w] -> uint32 [n, 8]
    canonical digests.  Words are taken mod p as they are absorbed."""
    words = np.asarray(words, dtype=np.uint32)
    n, w = words.shape
    if w < 1:
        raise ValueError("poseidon2 words: expected at least one word a row")
    state = np.zeros((n, WIDTH), dtype=np.uint64)
    for off in range(0, w, RATE):
        block = words[:, off:off + RATE].astype(np.uint64) % _P
        cw = block.shape[1]
        state[:, :cw] = (state[:, :cw] + block) % _P
        state = permute(state)
    return state[:, :RATE].astype(np.uint32)


def hash_words(words: torch.Tensor) -> torch.Tensor:
    """words: int32 [n, w] (u32 bit patterns) on the CPU -> int32 [n, 8]
    canonical digests."""
    if words.device.type != "cpu":
        _build.count_launch("poseidon2")
    digests = hash_numpy(words.contiguous().numpy().view(np.uint32))
    return torch.from_numpy(digests.view(np.int32))


def hash_words_host(words) -> np.ndarray:
    """Hash of one u32-word message on the host; returns uint32[8]."""
    return hash_numpy(np.asarray(words, dtype=np.uint32).reshape(1, -1))[0]
