"""BabyBear prime field (p = 2^31 - 2^27 + 1) on torch tensors.

Counterpart of valida_tpu/field/babybear.py.  Field words are torch.int32
tensors in Montgomery form (x·R mod p, R = 2^32) except at hash and commit
boundaries, exactly as in the reference, so every array is equal word for
word to the reference's.  The arithmetic widens to int64: p^2 < 2^62, so
`(a*b) % p` is exact there and a Montgomery product is
`((a*b) % p) * R^-1 % p`.  Canonical residues in [0, p) are unique, so any
exact reduction gives the reference's bits.
"""

from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# Constants (own copies of the reference's)
# ---------------------------------------------------------------------------

P = 2013265921  # 2^31 - 2^27 + 1
TWO_ADICITY = 27
GENERATOR = 31  # multiplicative group generator (canonical form)
MONTY_MU = 2281701377  # p^{-1} mod 2^32
R1 = 268435454  # 2^32 mod p ("one" in Montgomery form)
R2 = 1172168163  # 2^64 mod p
R_INV = pow(1 << 32, P - 2, P)  # 2^-32 mod p

# two-adic generator chain: g[k] has order 2^k; g[27] = 31^15 mod p.
_G27 = 440564289
TWO_ADIC_GENERATORS = [1] * (TWO_ADICITY + 1)
TWO_ADIC_GENERATORS[TWO_ADICITY] = _G27
for _k in range(TWO_ADICITY - 1, -1, -1):
    TWO_ADIC_GENERATORS[_k] = (
        TWO_ADIC_GENERATORS[_k + 1] * TWO_ADIC_GENERATORS[_k + 1] % P
    )
assert TWO_ADIC_GENERATORS[0] == 1 and TWO_ADIC_GENERATORS[1] == P - 1


def two_adic_generator(bits: int) -> int:
    """Canonical-form generator of the order-2^bits subgroup."""
    return TWO_ADIC_GENERATORS[bits]


# ---------------------------------------------------------------------------
# Host-side (python int) helpers
# ---------------------------------------------------------------------------


def h_mul(a: int, b: int) -> int:
    return a * b % P


def h_inv(a: int) -> int:
    return pow(a, P - 2, P)


def to_monty_int(x: int) -> int:
    return (x << 32) % P


# ---------------------------------------------------------------------------
# Tensor primitives: int32 in, int32 out (values in [0, p))
# ---------------------------------------------------------------------------


def _wide(a):
    return a.to(torch.int64) if isinstance(a, torch.Tensor) else int(a)


def _narrow(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.int32)


def mul(a, b) -> torch.Tensor:
    """Montgomery product of Montgomery-form inputs."""
    return _narrow((_wide(a) * _wide(b)) % P * R_INV % P)


def add(a, b) -> torch.Tensor:
    return _narrow((_wide(a) + _wide(b)) % P)


def sub(a, b) -> torch.Tensor:
    return _narrow((_wide(a) - _wide(b)) % P)


def neg(a) -> torch.Tensor:
    return _narrow((-_wide(a)) % P)


def to_monty(x) -> torch.Tensor:
    """Canonical (in [0, p)) -> Montgomery form."""
    return _narrow(_wide(x) * R1 % P)


def from_monty(x) -> torch.Tensor:
    """Montgomery form -> canonical in [0, p)."""
    return _narrow(_wide(x) * R_INV % P)
