"""Poseidon2 over BabyBear, width 16, S-box x^7: the arithmetic Merkle
hasher (`hasher="poseidon2"`).

Counterpart of valida_tpu/crypto/poseidon2.py:
  * 8 external rounds (4 + 4) with the block-circulant matrix
    circ(2·M4, M4, M4, M4), M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]];
  * 13 internal rounds: S-box on lane 0, then x -> sum(x)·1 + diag(d)·x;
  * round constants and the diagonal from a SHA-256 expansion of a fixed
    seed.
The sponge has rate 8 and capacity 8 over u32 words taken mod p; a digest
is 8 canonical field words, the same shape as a Keccak digest.

`hash_words` runs the CUDA kernel csrc/poseidon2.cu (replacing
poseidon2._poseidon2_pallas) on a CUDA tensor, for every batch size, and
the plain version below on a CPU tensor.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import _build
from ..convert import from_reference, table, to_numpy
from ..field import babybear as bb

WIDTH = 16
RATE = 8
EXTERNAL_ROUNDS = 8  # 4 + 4
INTERNAL_ROUNDS = 13

_SEED = b"validia seed/poseidon2"


def _expand(n: int, tag: bytes) -> list[int]:
    out = []
    counter = 0
    while len(out) < n:
        digest = hashlib.sha256(
            _SEED + tag + counter.to_bytes(8, "little")).digest()
        counter += 1
        for i in range(0, 32, 4):
            word = int.from_bytes(digest[i:i + 4], "little")
            if word < 2 * bb.P:  # rejection removes the bias of the mod
                out.append(word % bb.P)
                if len(out) == n:
                    break
    return out


EXTERNAL_CONSTANTS = np.array(
    _expand(EXTERNAL_ROUNDS * WIDTH, b"/ext"), dtype=np.uint32
).reshape(EXTERNAL_ROUNDS, WIDTH)
INTERNAL_CONSTANTS = np.array(_expand(INTERNAL_ROUNDS, b"/int"),
                              dtype=np.uint32)
INTERNAL_DIAG = np.array(_expand(WIDTH, b"/diag"), dtype=np.uint32)


def _monty(a: np.ndarray) -> np.ndarray:
    return ((a.astype(np.uint64) << 32) % np.uint64(bb.P)).astype(np.uint32)


def _constants_monty() -> np.ndarray:
    """All constants in Montgomery form, in the kernel's layout: external
    (round-major), internal, diagonal."""
    return np.concatenate([_monty(EXTERNAL_CONSTANTS).reshape(-1),
                           _monty(INTERNAL_CONSTANTS), _monty(INTERNAL_DIAG)])


def _consts(device):
    """(external [8, 16], internal [13], diagonal [16]) in Montgomery form
    on `device`."""
    flat = table(_constants_monty, device=device)
    n_ext = EXTERNAL_ROUNDS * WIDTH
    return (flat[:n_ext].reshape(EXTERNAL_ROUNDS, WIDTH),
            flat[n_ext:n_ext + INTERNAL_ROUNDS],
            flat[n_ext + INTERNAL_ROUNDS:])


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _sbox7(x):
    x2 = bb.mul_plain(x, x)
    x4 = bb.mul_plain(x2, x2)
    return bb.mul_plain(bb.mul_plain(x4, x2), x)


def _external_linear(state):
    """circ(2·M4, M4, M4, M4) on [..., 16]: M4 on each block of four
    lanes, then every lane gains the sum over the blocks.  The sums stay
    far below 2^63, so each is reduced once."""
    s4 = state.to(torch.int64).reshape(state.shape[:-1] + (4, 4))
    x0, x1, x2, x3 = s4.unbind(-1)
    t = x0 + x1 + x2 + x3
    m4b = torch.stack([t + x0 + 2 * x1, t + x1 + 2 * x2, t + x2 + 2 * x3,
                       t + x3 + 2 * x0], dim=-1)  # [..., block, lane]
    out = m4b + m4b.sum(dim=-2, keepdim=True)
    return (out % bb.P).to(torch.int32).reshape(state.shape)


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation: state [..., 16] Montgomery int32."""
    ext_c, int_c, diag = _consts(state.device)
    state = _external_linear(state)
    half = EXTERNAL_ROUNDS // 2
    for r in range(half):
        state = _external_linear(_sbox7(bb.add_plain(state, ext_c[r])))
    for r in range(INTERNAL_ROUNDS):
        s0 = _sbox7(bb.add_plain(state[..., 0], int_c[r]))
        state = torch.cat([s0[..., None], state[..., 1:]], dim=-1)
        total = state.sum(dim=-1, dtype=torch.int64) % bb.P
        state = bb.add_plain(bb.mul_plain(state, diag), total[..., None])
    for r in range(half, EXTERNAL_ROUNDS):
        state = _external_linear(_sbox7(bb.add_plain(state, ext_c[r])))
    return state


def hash_words_plain(words: torch.Tensor) -> torch.Tensor:
    """words: int32 [n, w] (u32 bit patterns) -> int32 [n, 8] canonical."""
    n, w = words.shape
    state = torch.zeros(n, WIDTH, dtype=torch.int32, device=words.device)
    for off in range(0, w, RATE):
        block = bb.from_wrapped_u32_plain(words[:, off:off + RATE])
        cw = block.shape[1]
        state = torch.cat([bb.add_plain(state[:, :cw], block), state[:, cw:]],
                          dim=-1)
        state = permute(state)
    return bb.from_monty_plain(state[:, :RATE])


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_UPLOADED: set = set()  # CUDA device indices whose constants are in place


def _upload_constants(device: torch.device) -> None:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index in _UPLOADED:
        return
    consts = np.ascontiguousarray(_constants_monty())
    with torch.cuda.device(index):
        err = _build.lib("poseidon2").poseidon2_set_constants(
            consts.ctypes.data, int(consts.size))
    if err != 0:
        raise RuntimeError(f"poseidon2_set_constants: CUDA error {err}")
    _UPLOADED.add(index)


def hash_words(words: torch.Tensor) -> torch.Tensor:
    """Sponge hash of u32-word rows: int32 [n, w] -> int32 [n, 8] canonical
    digests.  Words are taken mod p as they are absorbed."""
    if words.device.type == "cpu":
        return hash_words_plain(words)
    batch, n_words = words.shape
    _build.check_input(words, "poseidon2 words")
    if n_words < 1:
        raise ValueError("poseidon2 words: expected at least one word a row")
    out = torch.empty(batch, RATE, dtype=torch.int32, device=words.device)
    if batch == 0:
        return out
    _upload_constants(words.device)
    _build.launch("poseidon2", "poseidon2_launch", words, out, batch, n_words)
    _build.count_launch("poseidon2")
    return out


# ---------------------------------------------------------------------------
# Host mirror
# ---------------------------------------------------------------------------


def hash_words_host(words) -> np.ndarray:
    """Hash of one u32-word message on the host; returns uint32[8]."""
    w = np.asarray(words, dtype=np.uint32).reshape(1, -1)
    return to_numpy(hash_words_plain(from_reference(w)))[0]
