"""Degree-5 binomial extension of BabyBear: F_p[x] / (x^5 - W), W = 2.

Counterpart of valida_tpu/field/ext.py.  On the device an element is a
trailing axis of 5 int32 words in Montgomery form, the coefficient of x^0
first.  Host scalars are 5-tuples of canonical python ints.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..convert import from_reference, index_tensor, table
from . import babybear as bb

D = 5  # extension degree
W = 2  # binomial nonresidue: x^5 = 2


# ---------------------------------------------------------------------------
# Device side (trailing axis = 5, Montgomery int32)
# ---------------------------------------------------------------------------


def ext_add(a, b):
    return bb.add(a, b)


def ext_sub(a, b):
    return bb.sub(a, b)


def ext_neg(a):
    return bb.neg(a)


def ext_scale(a, s):
    """ext array times a base-field array s (Montgomery), broadcast over
    the coefficients when s lacks the trailing axis."""
    return bb.mul(a, s[..., None] if s.dim() == a.dim() - 1 else s)


# pair (k, i) at flat position 5k + i takes a_i * b_((k-i) mod 5), doubled
# where the exponent wrapped (i + j >= 5, since x^5 = 2)
_EM_I = tuple(i for k in range(D) for i in range(D))
_EM_J = tuple((k - i) % D for k in range(D) for i in range(D))
_EM_OVF = [i + ((k - i) % D) >= D for k in range(D) for i in range(D)]


@functools.lru_cache(maxsize=None)
def _em_factor() -> np.ndarray:
    """2 at the wrapped pairs of `_EM_OVF`, 1 elsewhere."""
    return np.array([2 if o else 1 for o in _EM_OVF], dtype=np.uint32)


def ext_mul(a, b):
    """Product modulo x^5 - W: c_k = sum_{i+j=k} a_i b_j + W sum_{i+j=k+5}
    a_i b_j.  Each of the 25 products is reduced below p, so a doubled
    sum of five stays below 2^35 and the Montgomery factor R^-1 is taken
    once per c_k."""
    a, b = torch.broadcast_tensors(a, b)
    dev = a.device
    prod = (a.index_select(-1, index_tensor(_EM_I, dev)).to(torch.int64)
            * b.index_select(-1, index_tensor(_EM_J, dev)).to(torch.int64)
            % bb.P)
    prod = prod * table(_em_factor, device=prod.device)
    c = prod.reshape(prod.shape[:-1] + (D, D)).sum(dim=-1)
    return (c % bb.P * bb.R_INV % bb.P).to(torch.int32)


def ext_mul_base(a, s):
    """ext times base (s a base-field Montgomery array, one per element)."""
    return bb.mul(a, s[..., None])


def ext_one_like(a):
    one = torch.zeros_like(a)
    one[..., 0].fill_(bb.ONE)
    return one


def ext_exp(a, e: int):
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else ext_mul(result, base)
        e >>= 1
        if e:
            base = ext_mul(base, base)
    if result is None:
        return ext_one_like(a)
    return result


# Frobenius x -> x^p: p = 1 mod 5 and x^5 = W, so x^p = W^((p-1)/5) x and
# coefficient i scales by W^(i(p-1)/5).
_FROB_BASE = pow(W, (bb.P - 1) // 5, bb.P)
_FROB_COEFFS = [pow(_FROB_BASE, i, bb.P) for i in range(D)]
_FROB_COEFFS_MONTY = [bb.monty_scalar(c) for c in _FROB_COEFFS]


@functools.lru_cache(maxsize=None)
def _frob_monty() -> np.ndarray:
    return np.array(_FROB_COEFFS_MONTY, dtype=np.uint32)


def frobenius(a):
    return bb.mul(a, table(_frob_monty, device=a.device))


def ext_inv(a):
    """a^-1 = (a^p a^(p^2) a^(p^3) a^(p^4)) / norm(a): the product of the
    four conjugates, over the norm, which lies in the base field."""
    conj = frobenius(a)
    r = conj
    for _ in range(3):
        conj = frobenius(conj)
        r = ext_mul(r, conj)
    norm0 = ext_mul(a, r)[..., 0]
    return ext_mul_base(r, bb.inv_batch(norm0))


def ext_from_base(a):
    """Base-field Montgomery array -> ext array (a at coefficient 0)."""
    out = a.new_zeros(tuple(a.shape) + (D,))
    out[..., 0] = a
    return out


def ext_const(e, device) -> torch.Tensor:
    """Host ext scalar (canonical 5-tuple) -> Montgomery int32 [5]."""
    return from_reference(np.array([bb.monty_scalar(int(c) % bb.P)
                                    for c in e], dtype=np.uint32), device)


@functools.lru_cache(maxsize=None)
def _one_monty() -> np.ndarray:
    return np.array([bb.ONE, 0, 0, 0, 0], dtype=np.uint32)


def ext_one(device) -> torch.Tensor:
    """The ext 1 as Montgomery int32 [5], a cached table (so a captured
    stage may use it)."""
    return table(_one_monty, device=device)


# ---------------------------------------------------------------------------
# Host side (tuples of canonical ints)
# ---------------------------------------------------------------------------

E_ZERO = (0, 0, 0, 0, 0)
E_ONE = (1, 0, 0, 0, 0)


def e_add(a, b):
    return tuple(bb.h_add(x, y) for x, y in zip(a, b))


def e_sub(a, b):
    return tuple(bb.h_sub(x, y) for x, y in zip(a, b))


def e_neg(a):
    return tuple((bb.P - x) % bb.P for x in a)


def e_mul(a, b):
    c = [0] * D
    for i in range(D):
        if a[i] == 0:
            continue
        for j in range(D):
            k = i + j
            t = a[i] * b[j] % bb.P
            if k >= D:
                c[k - D] = (c[k - D] + t * W) % bb.P
            else:
                c[k] = (c[k] + t) % bb.P
    return tuple(c)


def e_scale(a, s: int):
    return tuple(x * s % bb.P for x in a)


def e_from_base(x: int):
    return (x % bb.P, 0, 0, 0, 0)


def e_exp(a, e: int):
    result = E_ONE
    base = a
    while e > 0:
        if e & 1:
            result = e_mul(result, base)
        e >>= 1
        base = e_mul(base, base)
    return result


def e_inv(a):
    def frob(x):
        return tuple(x[i] * _FROB_COEFFS[i] % bb.P for i in range(D))

    conj = frob(a)
    r = conj
    for _ in range(3):
        conj = frob(conj)
        r = e_mul(r, conj)
    norm = e_mul(a, r)
    if any(norm[1:]):
        raise ArithmeticError("norm must lie in the base field")
    return e_scale(r, bb.h_inv(norm[0]))


def e_powers(a, n: int):
    """[1, a, a^2, ..., a^(n-1)]"""
    out = [E_ONE]
    for _ in range(n - 1):
        out.append(e_mul(out[-1], a))
    return out
