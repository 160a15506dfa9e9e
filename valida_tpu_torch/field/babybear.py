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


def h_add(a: int, b: int) -> int:
    s = a + b
    return s - P if s >= P else s


def h_sub(a: int, b: int) -> int:
    d = a - b
    return d + P if d < 0 else d


def h_inv(a: int) -> int:
    return pow(a, P - 2, P)


def h_exp(a: int, e: int) -> int:
    return pow(a, e, P)


def to_monty_int(x: int) -> int:
    return (x << 32) % P


def from_monty_int(x: int) -> int:
    return x * R_INV % P


def monty_scalar(x: int) -> int:
    """Python-int canonical value -> Montgomery-form python int."""
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


def double(a) -> torch.Tensor:
    return add(a, a)


def from_wrapped_u32(x: torch.Tensor) -> torch.Tensor:
    """Arbitrary u32 (int32 bit patterns) -> Montgomery form of the value
    taken mod p."""
    return _narrow((x.to(torch.int64) & 0xFFFFFFFF) % P * R1 % P)


def exp(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a python-int exponent (square and multiply)."""
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    if result is None:
        return torch.full_like(a, R1)
    return result


def inv(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2); maps 0 -> 0."""
    return exp(a, P - 2)


def inv_batch(a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse with 0 -> 0 through a product tree: products
    up, one `inv` at the root, then inv(x0) = inv(x0*x1)*x1 back down;
    about 3 multiplies an element.  Same words as `inv`."""
    shape = a.shape
    flat = a.reshape(-1)
    n = int(flat.shape[0])
    if n <= 1:
        return inv(a)
    zero = flat == 0
    flat = torch.where(zero, R1, flat)
    size = 1 << (n - 1).bit_length()
    if size != n:
        flat = torch.cat([flat, flat.new_full((size - n,), R1)])
    levels = [flat]
    while levels[-1].shape[0] > 1:
        x = levels[-1]
        levels.append(mul(x[0::2], x[1::2]))
    invs = inv(levels[-1])
    for x in levels[-2::-1]:
        pair = torch.stack([mul(invs, x[1::2]), mul(invs, x[0::2])], dim=1)
        invs = pair.reshape(x.shape[0])
    return torch.where(zero, 0, invs[:n]).reshape(shape)


ONE = R1  # Montgomery-form 1 as a python int
ZERO = 0
