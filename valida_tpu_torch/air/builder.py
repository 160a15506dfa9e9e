"""AIR constraint builders.

Counterpart of valida_tpu/air/builder.py.  A chip writes its constraints
once in `eval(builder)`; the same code runs in three modes (the Rust
machine crate's builders):

  * SymbolicBuilder — degree tracking only, for log_quotient_degree.
  * VectorBuilder  — values are int32 tensors over an evaluation domain
    (Montgomery, base [Q] / ext [Q, 5]) on the prover's device; used both
    for quotient evaluation (folded with powers of alpha) and for the debug
    row checker (collect every constraint for zero assertion).
  * ScalarBuilder  — values are host extension scalars (tuples), used for
    out-of-domain constraint verification at zeta.

Expression values support +, -, *, unary minus with automatic base->ext
promotion; python ints are canonical constants.
"""

from __future__ import annotations

import torch

from ..convert import index_tensor
from ..field import babybear as bb
from ..field import ext as extf
from ..poly.ntt import _mod_sum


# ---------------------------------------------------------------------------
# Symbolic mode
# ---------------------------------------------------------------------------


class SymExpr:
    __slots__ = ("deg",)

    def __init__(self, deg: int):
        self.deg = deg

    @staticmethod
    def _d(o):
        return o.deg if isinstance(o, SymExpr) else 0

    def __add__(self, o):
        return SymExpr(max(self.deg, SymExpr._d(o)))

    __radd__ = __add__
    __sub__ = __add__
    __rsub__ = __add__

    def __mul__(self, o):
        return SymExpr(self.deg + SymExpr._d(o))

    __rmul__ = __mul__

    def __neg__(self):
        return SymExpr(self.deg)


# ---------------------------------------------------------------------------
# Vector mode (device tensors, Montgomery)
# ---------------------------------------------------------------------------


class VVal:
    """Wrapped device value: base [..] or ext [.., 5] Montgomery int32.  A
    constant is a 0-dim tensor that broadcasts."""

    __slots__ = ("arr", "is_ext")

    def __init__(self, arr, is_ext: bool):
        self.arr = arr
        self.is_ext = is_ext

    @staticmethod
    def const(c: int, device) -> "VVal":
        return VVal(torch.full((), bb.monty_scalar(int(c) % bb.P),
                               dtype=torch.int32, device=device), False)

    def _coerce(self, o) -> "VVal":
        if isinstance(o, VVal):
            return o
        return VVal.const(int(o), self.arr.device)

    def _as_ext(self):
        if self.is_ext:
            return self.arr
        base = self.arr
        if base.dim() == 0:
            base = base[None]
        z = torch.zeros_like(base)
        return torch.stack([base, z, z, z, z], dim=-1)

    def __add__(self, o):
        o = self._coerce(o)
        if self.is_ext or o.is_ext:
            return VVal(bb.add(self._as_ext(), o._as_ext()), True)
        return VVal(bb.add(self.arr, o.arr), False)

    __radd__ = __add__

    def __sub__(self, o):
        o = self._coerce(o)
        if self.is_ext or o.is_ext:
            return VVal(bb.sub(self._as_ext(), o._as_ext()), True)
        return VVal(bb.sub(self.arr, o.arr), False)

    def __rsub__(self, o):
        return self._coerce(o).__sub__(self)

    def __mul__(self, o):
        o = self._coerce(o)
        if self.is_ext and o.is_ext:
            return VVal(extf.ext_mul(self.arr, o.arr), True)
        if self.is_ext:
            base = o.arr[..., None] if o.arr.dim() else o.arr
            return VVal(bb.mul(self.arr, base), True)
        if o.is_ext:
            base = self.arr[..., None] if self.arr.dim() else self.arr
            return VVal(bb.mul(o.arr, base), True)
        return VVal(bb.mul(self.arr, o.arr), False)

    __rmul__ = __mul__

    def __neg__(self):
        return VVal(bb.neg(self.arr), self.is_ext)


# ---------------------------------------------------------------------------
# Scalar mode (host ext tuples)
# ---------------------------------------------------------------------------


class SVal:
    __slots__ = ("e",)

    def __init__(self, e):
        self.e = e

    @staticmethod
    def const(c: int) -> "SVal":
        return SVal(extf.e_from_base(int(c)))

    @staticmethod
    def _coerce(o):
        if isinstance(o, SVal):
            return o
        return SVal.const(int(o))

    def __add__(self, o):
        return SVal(extf.e_add(self.e, SVal._coerce(o).e))

    __radd__ = __add__

    def __sub__(self, o):
        return SVal(extf.e_sub(self.e, SVal._coerce(o).e))

    def __rsub__(self, o):
        return SVal(extf.e_sub(SVal._coerce(o).e, self.e))

    def __mul__(self, o):
        return SVal(extf.e_mul(self.e, SVal._coerce(o).e))

    __rmul__ = __mul__

    def __neg__(self):
        return SVal(extf.e_neg(self.e))


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


class _Filtered:
    def __init__(self, builder, condition):
        self.b = builder
        self.cond = condition

    def when(self, condition):
        return _Filtered(self.b, self.cond * condition)

    def when_ne(self, x, y):
        return _Filtered(self.b, self.cond * (x - y))

    def assert_zero(self, e):
        self.b.assert_zero(self.cond * e)

    def assert_eq(self, a, c):
        self.assert_zero(a - c)

    assert_eq_ext = assert_eq

    def assert_one(self, e):
        self.assert_zero(e - 1)


class BaseBuilder:
    """Shared filtered-assertion sugar; subclasses set row windows and
    selector values and implement assert_zero."""

    machine = None
    trace_height = None  # set by evaluation contexts; None in symbolic mode

    def when(self, condition):
        return _Filtered(self, condition)

    def when_ne(self, x, y):
        return _Filtered(self, x - y)

    def when_transition(self):
        return _Filtered(self, self.is_transition)

    def when_first_row(self):
        return _Filtered(self, self.is_first_row)

    def when_last_row(self):
        return _Filtered(self, self.is_last_row)

    def assert_eq(self, a, b):
        self.assert_zero(a - b)

    assert_eq_ext = assert_eq

    def assert_one(self, e):
        self.assert_zero(e - 1)

    assert_one_ext = assert_one

    def assert_bool(self, e):
        self.assert_zero(e * (e - 1))

    def const(self, c):
        raise NotImplementedError


class SymbolicBuilder(BaseBuilder):
    def __init__(self, machine, chip):
        self.machine = machine
        w = chip.width()
        pw = chip.preprocessed_width()
        n_perm = len(chip.all_interactions(machine)) + 1
        self.main_local = [SymExpr(1) for _ in range(w)]
        self.main_next = [SymExpr(1) for _ in range(w)]
        self.preprocessed_local = [SymExpr(1) for _ in range(pw)]
        self.preprocessed_next = [SymExpr(1) for _ in range(pw)]
        self.perm_local = [SymExpr(1) for _ in range(n_perm)]
        self.perm_next = [SymExpr(1) for _ in range(n_perm)]
        self.perm_challenges = [SymExpr(0) for _ in range(3)]
        self.is_first_row = SymExpr(1)
        self.is_last_row = SymExpr(1)
        self.is_transition = SymExpr(0)
        self.trace_height = 1
        self.max_degree = 0

    def const(self, c):
        return SymExpr(0)

    def assert_zero(self, e):
        self.max_degree = max(self.max_degree, SymExpr._d(e))


class VectorBuilder(BaseBuilder):
    """Device-tensor builder over an evaluation domain: collects every
    constraint; `fold` combines them with powers of alpha (quotient), the
    debug checker tests each for zero."""

    def __init__(self, machine, *, main_local, main_next, prep_local,
                 prep_next, perm_local, perm_next, perm_challenges,
                 is_first_row, is_last_row, is_transition, alpha=None,
                 trace_height=None):
        self.machine = machine
        self.trace_height = trace_height
        self.main_local = main_local
        self.main_next = main_next
        self.preprocessed_local = prep_local
        self.preprocessed_next = prep_next
        self.perm_local = perm_local
        self.perm_next = perm_next
        self.perm_challenges = perm_challenges
        self.is_first_row = is_first_row
        self.is_last_row = is_last_row
        self.is_transition = is_transition
        self.device = is_first_row.arr.device
        self.alpha = alpha
        self.collected = []

    def const(self, c):
        return VVal.const(c, self.device)

    def assert_zero(self, e):
        if not isinstance(e, VVal):
            e = self.const(int(e))
        self.collected.append(e)

    def fold(self):
        """sum_i c_i * alpha^(K-1-i) over the collected constraints: the
        value of the Rust prover's Horner accumulation acc = acc*alpha + c.

        Base-field constraints (all chip constraints) are stacked into one
        [K_base, Q] array and contracted against their alpha powers with
        one modular sum per coefficient; extension constraints (the
        permutation AIR) combine one at a time.  Returns the ext VVal, or
        None without constraints.
        """
        k = len(self.collected)
        if k == 0:
            return None
        # alpha powers [k, 5] by doubling
        a = self.alpha._as_ext()
        arr = extf.ext_one(self.device)[None, :]
        cur = a[None, :] if a.dim() == 1 else a
        length = 1
        while length < k:
            arr = torch.cat([arr, extf.ext_mul(arr, cur)], dim=0)
            cur = extf.ext_mul(cur, cur)
            length *= 2

        base_idx = [i for i, c in enumerate(self.collected) if not c.is_ext]
        ext_idx = [i for i, c in enumerate(self.collected) if c.is_ext]

        partials = []
        if base_idx:
            # broadcast scalars (filtered constants etc.) to a common shape
            shapes = [self.collected[i].arr.shape for i in base_idx
                      if self.collected[i].arr.dim()]
            shape = shapes[0] if shapes else ()
            stack = torch.stack([
                torch.broadcast_to(self.collected[i].arr, shape)
                for i in base_idx
            ], dim=0)  # [K_base, Q]
            apows = arr.index_select(0, index_tensor(  # [K_base, 5]
                tuple(k - 1 - i for i in base_idx), self.device))
            apows = apows.reshape(apows.shape[:1] + (1,) * len(shape) + (5,))
            comps = [_mod_sum(bb.mul(stack, apows[..., d]), axis=0)
                     for d in range(5)]
            partials.append(VVal(torch.stack(comps, dim=-1), True))
        for i in ext_idx:
            partials.append(VVal(self.collected[i]._as_ext(), True)
                            * VVal(arr[k - 1 - i], True))
        acc = partials[0]
        for t in partials[1:]:
            acc = acc + t
        return VVal(acc._as_ext(), True)


class ScalarBuilder(BaseBuilder):
    """Host ext-scalar builder for OOD verification at zeta."""

    def __init__(self, machine, *, main_local, main_next, prep_local,
                 prep_next, perm_local, perm_next, perm_challenges,
                 is_first_row, is_last_row, is_transition, alpha,
                 trace_height=None):
        self.machine = machine
        self.trace_height = trace_height
        self.main_local = main_local
        self.main_next = main_next
        self.preprocessed_local = prep_local
        self.preprocessed_next = prep_next
        self.perm_local = perm_local
        self.perm_next = perm_next
        self.perm_challenges = perm_challenges
        self.is_first_row = is_first_row
        self.is_last_row = is_last_row
        self.is_transition = is_transition
        self.alpha = alpha
        self.accumulator = SVal.const(0)

    def const(self, c):
        return SVal.const(c)

    def assert_zero(self, e):
        e = SVal._coerce(e)
        self.accumulator = self.accumulator * self.alpha + e
