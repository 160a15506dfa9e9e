"""Degree-5 binomial extension of BabyBear: F_p[x] / (x^5 - W), W = 2.

Counterpart of valida_tpu/field/ext.py.  On the device an element is a
trailing axis of 5 int32 words in Montgomery form, the coefficient of x^0
first.  Host scalars are 5-tuples of canonical python ints (`ExtScalar`).
`ext_mul` and `ext_inv` run their plain versions on CPU tensors and
csrc/field.cu's kernels on the card; the other operations reach the
kernels through babybear's.
"""

from __future__ import annotations



from . import babybear as bb

D = 5  # extension degree
W = 2  # binomial nonresidue: x^5 = 2


# ---------------------------------------------------------------------------
# Device side (trailing axis = 5, Montgomery int32)
# ---------------------------------------------------------------------------


# pair (k, i) at flat position 5k + i takes a_i * b_((k-i) mod 5), doubled
# where the exponent wrapped (i + j >= 5, since x^5 = 2)
_EM_I = tuple(i for k in range(D) for i in range(D))
_EM_J = tuple((k - i) % D for k in range(D) for i in range(D))
_EM_OVF = [i + ((k - i) % D) >= D for k in range(D) for i in range(D)]


# Frobenius x -> x^p: p = 1 mod 5 and x^5 = W, so x^p = W^((p-1)/5) x and
# coefficient i scales by W^(i(p-1)/5).
_FROB_BASE = pow(W, (bb.P - 1) // 5, bb.P)
_FROB_COEFFS = [pow(_FROB_BASE, i, bb.P) for i in range(D)]
_FROB_COEFFS_MONTY = [bb.monty_scalar(c) for c in _FROB_COEFFS]


# ---------------------------------------------------------------------------
# Host side (tuples of canonical ints)
# ---------------------------------------------------------------------------

ExtScalar = tuple  # length-5 tuple of ints in [0, p)

E_ZERO = (0, 0, 0, 0, 0)
E_ONE = (1, 0, 0, 0, 0)


def e_add(a, b):
    return tuple(bb.h_add(x, y) for x, y in zip(a, b))


def e_sub(a, b):
    return tuple(bb.h_sub(x, y) for x, y in zip(a, b))


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
