"""Poseidon permutation over BabyBear, width 16, alpha = 5: the
challenger's permutation.

Counterpart of valida_tpu/crypto/poseidon.py: 4 + 4 full rounds around 22
partial rounds, each round adding constants, raising to the fifth power
(every lane, or lane 0 in a partial round) and multiplying by a 16 x 16
MDS matrix.  The constants come from one of two schemes:
  "p3rng" (default) or "p3rng:<interpret>-<sip>-<mds>": the Valida
    reference's own derivation chain as rebuilt in crypto/p3_rng.py;
  "sha256": a SHA-256 counter-mode expansion of the seed with a Cauchy MDS.
The environment variable VALIDA_TPU_POSEIDON picks the scheme at import,
`set_param_set` at run time.

`permute_host` is exact numpy uint64 arithmetic on one state;
`permute_device` is batched torch arithmetic in Montgomery form (the
grind's search).  Both are plain: the JAX package has no TPU kernel here.
"""

from __future__ import annotations

import functools
import hashlib
import os

import numpy as np
import torch

from ..convert import table
from ..field import babybear as bb

WIDTH = 16
ALPHA = 5
HALF_FULL_ROUNDS = 4  # 4 leading + 4 trailing full rounds
PARTIAL_ROUNDS = 22
FULL_ROUNDS = 2 * HALF_FULL_ROUNDS
NUM_ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS

SEED = b"validia seed"


def _expand_constants(n: int) -> list[int]:
    """Field elements from SHA-256(seed || counter), rejecting words
    >= 2p to remove the bias of the mod."""
    out: list[int] = []
    counter = 0
    while len(out) < n:
        digest = hashlib.sha256(SEED + counter.to_bytes(8, "little")).digest()
        counter += 1
        for i in range(0, 32, 4):
            word = int.from_bytes(digest[i:i + 4], "little")
            if word < 2 * bb.P:
                out.append(word % bb.P)
                if len(out) == n:
                    break
    return out


PARAM_SET = os.environ.get("VALIDA_TPU_POSEIDON", "p3rng")


@functools.lru_cache(maxsize=None)
def _build_params(param_set: str):
    """(round constants [30, 16], MDS [16, 16]) as canonical np.uint64."""
    if param_set == "p3rng" or param_set.startswith("p3rng:"):
        from .p3_rng import P3RNG_DEFAULT_VARIANT, p3rng_params

        variant = (param_set.split(":", 1)[1] if ":" in param_set
                   else P3RNG_DEFAULT_VARIANT)
        rc_list, mds_list = p3rng_params(NUM_ROUNDS * WIDTH, variant, WIDTH)
        rc = np.array(rc_list, dtype=np.uint64).reshape(NUM_ROUNDS, WIDTH)
        return rc, np.array(mds_list, dtype=np.uint64)
    if param_set != "sha256":
        raise ValueError(f"unknown Poseidon parameter set {param_set!r}")
    rc = np.array(_expand_constants(NUM_ROUNDS * WIDTH),
                  dtype=np.uint64).reshape(NUM_ROUNDS, WIDTH)
    # Cauchy MDS: M[i][j] = 1/(x_i + y_j), x_i = i, y_j = WIDTH + j.
    mds = np.array([[bb.h_inv(i + WIDTH + j) for j in range(WIDTH)]
                    for i in range(WIDTH)], dtype=np.uint64)
    return rc, mds


ROUND_CONSTANTS, MDS = _build_params(PARAM_SET)

_P64 = np.uint64(bb.P)


def set_param_set(name: str) -> None:
    """Switch the active constants at run time."""
    global PARAM_SET, ROUND_CONSTANTS, MDS
    if name == PARAM_SET:
        return
    ROUND_CONSTANTS, MDS = _build_params(name)
    PARAM_SET = name


def _partial(r: int) -> bool:
    return HALF_FULL_ROUNDS <= r < HALF_FULL_ROUNDS + PARTIAL_ROUNDS


# ---------------------------------------------------------------------------
# Host implementation (numpy uint64, exact)
# ---------------------------------------------------------------------------


def _h_sbox(x: np.ndarray) -> np.ndarray:
    x2 = x * x % _P64
    x4 = x2 * x2 % _P64
    return x4 * x % _P64


def permute_host(state) -> np.ndarray:
    """state: 16 canonical ints -> np.uint64[16]."""
    s = np.asarray(state, dtype=np.uint64) % _P64
    for r in range(NUM_ROUNDS):
        s = (s + ROUND_CONSTANTS[r]) % _P64
        if _partial(r):
            s[0] = _h_sbox(s[:1])[0]
        else:
            s = _h_sbox(s)
        # each product is reduced below p before the sum: 16 p < 2^35
        s = ((MDS * s[np.newaxis, :]) % _P64).sum(axis=1) % _P64
    return s


# ---------------------------------------------------------------------------
# Batched implementation (torch int32, Montgomery form)
# ---------------------------------------------------------------------------


def _monty_params(param_set: str):
    """The constants of `param_set` in Montgomery form, np.uint32."""
    return tuple(((a << 32) % _P64).astype(np.uint32)
                 for a in _build_params(param_set))


def _d_sbox(x):
    x2 = bb.mul(x, x)
    x4 = bb.mul(x2, x2)
    return bb.mul(x4, x)


def _d_mds(state, mds):
    """state [..., 16] Montgomery -> MDS @ state.  The 16 products of a row
    are reduced below p, so their sum stays below 2^35."""
    prod = state[..., None, :].to(torch.int64) * mds.to(torch.int64) % bb.P
    return (prod.sum(dim=-1) % bb.P * bb.R_INV % bb.P).to(torch.int32)


def permute_device(state: torch.Tensor) -> torch.Tensor:
    """Batched Poseidon permutation: state [..., 16] Montgomery int32."""
    rc, mds = table(_monty_params, PARAM_SET, device=state.device)
    for r in range(NUM_ROUNDS):
        state = bb.add(state, rc[r])
        if _partial(r):
            state = torch.cat([_d_sbox(state[..., 0:1]), state[..., 1:]],
                              dim=-1)
        else:
            state = _d_sbox(state)
        state = _d_mds(state, mds)
    return state
