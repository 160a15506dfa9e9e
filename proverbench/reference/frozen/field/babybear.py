"""BabyBear prime field (p = 2^31 - 2^27 + 1) on torch tensors.

Counterpart of valida_tpu/field/babybear.py.  Field words are torch.int32
tensors in Montgomery form (x·R mod p, R = 2^32) except at hash and commit
boundaries, exactly as in the reference, so every array is equal word for
word to the reference's.

Each operation has two versions.  The plain one (`mul_plain`, ...) widens
to int64: p^2 < 2^62, so `(a*b) % p` is exact there and a Montgomery
product is `((a*b) % p) * R^-1 % p`; it runs on any device.  The public
one (`mul`, ...) runs the plain version when its tensor operands lie on
the CPU and csrc/field.cu's kernels (32-bit Montgomery words, one pass)
when they lie on the card.  Both compute the same function on every int32
word, a word >= p or a negative bit pattern included, and canonical
residues in [0, p) are unique, so both give the reference's bits.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

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


def h_add(a: int, b: int) -> int:
    s = a + b
    return s - P if s >= P else s


def h_sub(a: int, b: int) -> int:
    d = a - b
    return d + P if d < 0 else d


def h_inv(a: int) -> int:
    return pow(a, P - 2, P)


def to_monty_int(x: int) -> int:
    return (x << 32) % P


def monty_scalar(x: int) -> int:
    """Python-int canonical value -> Montgomery-form python int."""
    return (x << 32) % P


# ---------------------------------------------------------------------------
# Plain versions: int32 in, int32 out (values in [0, p)), any device
# ---------------------------------------------------------------------------


def _wide(a):
    return a.to(torch.int64) if isinstance(a, torch.Tensor) else int(a)


def _narrow(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.int32)


def mul_plain(a, b) -> torch.Tensor:
    """Montgomery product of Montgomery-form inputs."""
    return _narrow((_wide(a) * _wide(b)) % P * R_INV % P)


def add_plain(a, b) -> torch.Tensor:
    return _narrow((_wide(a) + _wide(b)) % P)


def sub_plain(a, b) -> torch.Tensor:
    return _narrow((_wide(a) - _wide(b)) % P)


def to_monty_plain(x) -> torch.Tensor:
    """Canonical (in [0, p)) -> Montgomery form."""
    return _narrow(_wide(x) * R1 % P)


def from_monty_plain(x) -> torch.Tensor:
    """Montgomery form -> canonical in [0, p)."""
    return _narrow(_wide(x) * R_INV % P)


# ---------------------------------------------------------------------------
# The field kernels (csrc/field.cu): a tensor operand on the card launches
# them; only operands that all lie on the CPU (or are Python ints) run the
# plain versions above.  No fallback: a dtype, device mix or layout the
# kernels do not take raises.
# ---------------------------------------------------------------------------

# op codes of field_elementwise (csrc/field.cuh `Op`)
OPS = {"mul": 0, "add": 1, "sub": 2, "neg": 3, "to_monty": 4,
       "from_monty": 5, "from_wrapped_u32": 6}
MAX_DIMS = 6  # dims of a layout after merging (csrc/field.cu MAX_DIMS)
# [n, ndim, size[6], a_stride[6], b_stride[6], a_coef, b_coef]
_LAYOUT = ctypes.c_int64 * (2 + 3 * MAX_DIMS + 2)


def _plain_side(a, b=None) -> bool:
    """True when no operand is a tensor off the CPU."""
    return ((not isinstance(a, torch.Tensor) or a.device.type == "cpu")
            and (not isinstance(b, torch.Tensor) or b.device.type == "cpu"))


def _check(t: torch.Tensor, device, what: str) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: the field kernels take int32 words, got "
                        f"{t.dtype}")
    if t.device != device:
        raise ValueError(f"{what}: operands on {t.device} and {device}")


def _broadcast_shape(sa, sb) -> tuple:
    """The shape two operands broadcast to (torch.broadcast_shapes' rule,
    without its cost on every call)."""
    if sa == sb:
        return tuple(sa)
    nd = max(len(sa), len(sb))
    sa = (1,) * (nd - len(sa)) + tuple(sa)
    sb = (1,) * (nd - len(sb)) + tuple(sb)
    out = []
    for x, y in zip(sa, sb):
        if x != y and x != 1 and y != 1:
            raise ValueError(f"shapes {sa} and {sb} do not broadcast")
        out.append(y if x == 1 else x)
    return tuple(out)


def _bstrides(ts, st, shape) -> tuple:
    """The strides in words of an operand of shape ts and strides st
    broadcast to `shape` (0 where it broadcasts)."""
    off = len(shape) - len(ts)
    return tuple(0 if d < off or ts[d - off] == 1 else st[d - off]
                 for d in range(len(shape)))


def _layout(what, n, shape, sa, sb, ca=0, cb=0):
    """The kernels' host layout of n elements over `shape` (outer to
    inner) with the operands' strides sa and sb: dims of size 1 dropped
    and neighbours merged where both operands walk them as one."""
    sizes, xa, xb = [], [], []
    for size, x, y in zip(shape, sa, sb):
        if size == 1:
            continue
        if sizes and xa[-1] == x * size and xb[-1] == y * size:
            sizes[-1] *= size
            xa[-1], xb[-1] = x, y
        else:
            sizes.append(size)
            xa.append(x)
            xb.append(y)
    if not sizes:
        sizes, xa, xb = [1], [0], [0]
    nd = len(sizes)
    if nd > MAX_DIMS:
        raise ValueError(f"{what}: {nd} dims after merging (shape "
                         f"{tuple(shape)}); the field kernels take at most "
                         f"{MAX_DIMS}")
    pad = (0,) * (MAX_DIMS - nd)
    return _LAYOUT(n, nd, *sizes, *pad, *xa, *pad, *xb, *pad, ca, cb)


def _elementwise(name: str, a, b=None) -> torch.Tensor:
    """K1 on the operands: int32 tensors on one device (broadcast by
    strides, never copied) or Python ints, taken mod p here."""
    what = f"field_elementwise {name}"
    ta = a if isinstance(a, torch.Tensor) else None
    tb = b if isinstance(b, torch.Tensor) else None
    dev = (ta if ta is not None else tb).device
    if ta is not None:
        _check(ta, dev, what)
    if tb is not None:
        _check(tb, dev, what)
    if ta is not None and tb is not None:
        shape = _broadcast_shape(ta.shape, tb.shape)
    else:
        shape = tuple((ta if ta is not None else tb).shape)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    n = out.numel()
    if n == 0:
        return out
    # operands of the output's shape, contiguous: one dim, built without
    # `_layout`'s loops (the eager provers are bound by the host's cost a
    # call, and this is most calls)
    if ((ta is None or ta.is_contiguous() and ta.shape == shape)
            and (tb is None or tb.is_contiguous() and tb.shape == shape)):
        layout = _LAYOUT(n, 1, n, *(0,) * (MAX_DIMS - 1),
                         0 if ta is None else 1, *(0,) * (MAX_DIMS - 1),
                         0 if tb is None else 1, *(0,) * (MAX_DIMS + 1))
    else:
        layout = _layout(
            what, n, shape,
            _bstrides(ta.shape, ta.stride(), shape) if ta is not None
            else (0,) * len(shape),
            _bstrides(tb.shape, tb.stride(), shape) if tb is not None
            else (0,) * len(shape))
    wa = 0 if ta is not None else int(a) % P
    wb = 0 if tb is not None or b is None else int(b) % P
    _build.launch("field", "field_elementwise_launch", OPS[name], ta, tb,
                  wa, wb, out, layout)
    _build.count_launch("field_elementwise")
    return out


def mul(a, b) -> torch.Tensor:
    """Montgomery product of Montgomery-form inputs."""
    if _plain_side(a, b):
        return mul_plain(a, b)
    return _elementwise("mul", a, b)


def add(a, b) -> torch.Tensor:
    if _plain_side(a, b):
        return add_plain(a, b)
    return _elementwise("add", a, b)


def sub(a, b) -> torch.Tensor:
    if _plain_side(a, b):
        return sub_plain(a, b)
    return _elementwise("sub", a, b)


def to_monty(x) -> torch.Tensor:
    """Canonical (in [0, p)) -> Montgomery form."""
    if _plain_side(x):
        return to_monty_plain(x)
    return _elementwise("to_monty", x)


def from_monty(x) -> torch.Tensor:
    """Montgomery form -> canonical in [0, p)."""
    if _plain_side(x):
        return from_monty_plain(x)
    return _elementwise("from_monty", x)


ONE = R1  # Montgomery-form 1 as a python int
ZERO = 0
