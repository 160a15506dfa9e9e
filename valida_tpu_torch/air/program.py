"""A chip's constraint program, captured once for csrc/constraint.cu.

`ProgramBuilder` runs `chip.eval` and `eval_permutation_constraints` over
SSA nodes instead of tensors.  A node is base (one word) or extension (five
words) and is a leaf (a main, preprocessed or permutation column, local or
next), a selector (`is_first_row`, `is_last_row`, `is_transition`), an
input (challenge k, alpha, the cumulative sum), an immediate Montgomery
word, or an operation (add, sub, mul, neg on base, extension or mixed
operands, promoted as `VVal` promotes them).  Nodes are hash-consed, so a
sub-expression written twice is computed once, and operations on
immediates are folded on the host; arithmetic mod p is exact, so any
evaluation order of the same expression gives the same words.

A node whose operands are all uniform (inputs, immediates) is uniform: the
kernel computes it once per block (the challenge powers of `powers_of`,
the betas, the alpha powers of the fold) into a block-wide array.  The
rest is the row program, evaluated per row: row values live in slots that
a linear-scan allocation reuses, and each constraint is folded into a
64-bit extension accumulator by `ACC` as soon as it is made, with
alpha^(K-1-i) from the uniform array: sum_i c_i alpha^(K-1-i), the value
of the Rust prover's Horner accumulation and of `VectorBuilder.fold`.

The encoding is a flat int32 array [n, 4] of (code, dst, a, b), the
uniform instructions first.  `code` packs the operation, the operands'
extension flags, whether dst is a uniform word, and the operand kinds;
csrc/constraint.cuh reads the same fields.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..convert import from_reference
from ..field import babybear as bb
from .builder import BaseBuilder
from .lookup import eval_permutation_constraints

# operations (csrc/constraint.cuh `COp`)
OP_ADD, OP_SUB, OP_MUL, OP_NEG, OP_ACC, OP_LOAD = range(6)
# operand kinds (csrc/constraint.cuh `Kind`)
(K_SLOT, K_UNI, K_MAIN_L, K_MAIN_N, K_PREP_L, K_PREP_N, K_PERM_L, K_PERM_N,
 K_SEL, K_INPUT, K_IMM) = range(11)
# selector indices (K_SEL) and inputs (K_INPUT): challenges 0-2, then these
SEL_FIRST, SEL_LAST, SEL_TRANS = range(3)
IN_ALPHA, IN_CUM = 3, 4

_LEAF_KINDS = {"main_l": K_MAIN_L, "main_n": K_MAIN_N, "prep_l": K_PREP_L,
               "prep_n": K_PREP_N, "perm_l": K_PERM_L, "perm_n": K_PERM_N,
               "sel": K_SEL}
_HOST = {"add": bb.h_add, "sub": bb.h_sub,
         "mul": lambda a, b: a * b * bb.R_INV % bb.P}


def encode_code(op: int, a_ext: bool, b_ext: bool, dst_uni: bool,
                a_kind: int, b_kind: int) -> int:
    return (op | a_ext << 4 | b_ext << 5 | dst_uni << 6 | a_kind << 8
            | b_kind << 12)


class Node:
    """One SSA value of a `ProgramBuilder`: `kind` is "op", "imm",
    "input" or a leaf kind; `args` the operands (op), the word (imm) or
    the index (leaf, input)."""

    __slots__ = ("pb", "id", "kind", "op", "args", "is_ext", "uniform")

    def __init__(self, pb, kind, op, args, is_ext, uniform):
        self.pb = pb
        self.id = len(pb.nodes)
        self.kind = kind
        self.op = op
        self.args = args
        self.is_ext = is_ext
        self.uniform = uniform
        pb.nodes.append(self)

    def _coerce(self, o) -> "Node":
        return o if isinstance(o, Node) else self.pb.const(int(o))

    def __add__(self, o):
        return self.pb.binary("add", self, self._coerce(o))

    __radd__ = __add__

    def __sub__(self, o):
        return self.pb.binary("sub", self, self._coerce(o))

    def __rsub__(self, o):
        return self.pb.binary("sub", self._coerce(o), self)

    def __mul__(self, o):
        return self.pb.binary("mul", self, self._coerce(o))

    __rmul__ = __mul__

    def __neg__(self):
        return self.pb.neg(self)


class ProgramBuilder(BaseBuilder):
    """Builder whose values are `Node`s; `collected` the constraints in
    the order the chip asserts them."""

    def __init__(self, machine, chip, log_degree: int):
        self.machine = machine
        self.trace_height = 1 << log_degree
        self.nodes = []
        self._memo = {}
        self.collected = []
        w, pw = chip.width(), chip.preprocessed_width()
        n_perm = len(chip.all_interactions(machine)) + 1
        self.widths = (w, pw, n_perm)
        self.main_local = [self.leaf("main_l", c) for c in range(w)]
        self.main_next = [self.leaf("main_n", c) for c in range(w)]
        self.preprocessed_local = [self.leaf("prep_l", c) for c in range(pw)]
        self.preprocessed_next = [self.leaf("prep_n", c) for c in range(pw)]
        self.perm_local = [self.leaf("perm_l", m) for m in range(n_perm)]
        self.perm_next = [self.leaf("perm_n", m) for m in range(n_perm)]
        self.is_first_row = self.leaf("sel", SEL_FIRST)
        self.is_last_row = self.leaf("sel", SEL_LAST)
        self.is_transition = self.leaf("sel", SEL_TRANS)
        self.perm_challenges = [self._input(k) for k in range(3)]
        self.alpha = self._input(IN_ALPHA)
        self.cumulative_sum = self._input(IN_CUM)

    # -- nodes ---------------------------------------------------------------

    def _make(self, key, kind, op, args, is_ext, uniform) -> Node:
        node = self._memo.get(key)
        if node is None:
            node = self._memo[key] = Node(self, kind, op, args, is_ext,
                                          uniform)
        return node

    def leaf(self, kind: str, idx: int) -> Node:
        return self._make((kind, idx), kind, None, idx,
                          kind in ("perm_l", "perm_n"), False)

    def _input(self, k: int) -> Node:
        return self._make(("input", k), "input", None, k, True, True)

    def imm(self, word: int) -> Node:
        return self._make(("imm", word), "imm", None, word, False, True)

    def const(self, c):
        return self.imm(bb.monty_scalar(int(c) % bb.P))

    def binary(self, op: str, a: Node, b: Node) -> Node:
        if a.kind == "imm" and b.kind == "imm":
            return self.imm(_HOST[op](a.args, b.args))
        zero, one = 0, bb.R1
        if op == "add" and (a.kind == "imm" and a.args == zero):
            return b
        if op in ("add", "sub") and b.kind == "imm" and b.args == zero:
            return a
        if op == "sub" and a.kind == "imm" and a.args == zero:
            return self.neg(b)
        if op == "mul":
            if b.kind == "imm" and b.args == one:
                return a
            if a.kind == "imm" and a.args == one:
                return b
        if op in ("add", "mul") and a.id > b.id:  # commutative: one order
            a, b = b, a
        return self._make((op, a.id, b.id), "op", op, (a, b),
                          a.is_ext or b.is_ext, a.uniform and b.uniform)

    def neg(self, a: Node) -> Node:
        if a.kind == "imm":
            return self.imm((bb.P - a.args) % bb.P)
        return self._make(("neg", a.id), "op", "neg", (a,), a.is_ext,
                          a.uniform)

    def assert_zero(self, e):
        if not isinstance(e, Node):
            e = self.const(int(e))
        self.collected.append(e)


class Program:
    """A chip's encoded constraint program: `code` int32 [n, 4] (the
    first `n_uniform` rows the uniform program), the uniform words and row
    slots it needs, the operand widths (main, preprocessed, permutation
    extension columns) and, for a bound, the count of each instruction
    form (`forms`: (op name, a_ext, b_ext) -> count, per row)."""

    def __init__(self, code, n_uniform, uni_words, slot_words, widths,
                 n_constraints, forms):
        self.code = code
        self.n_uniform = n_uniform
        self.uni_words = uni_words
        self.slot_words = slot_words
        self.widths = widths
        self.n_constraints = n_constraints
        self.forms = forms
        self._on = {}

    @property
    def n_row(self) -> int:
        return int(self.code.shape[0]) - self.n_uniform

    def on(self, device) -> torch.Tensor:
        """The code as an int32 tensor on `device`, uploaded once (before
        any graph capture: the staged prover's eager first run)."""
        key = str(device)
        t = self._on.get(key)
        if t is None:
            t = self._on[key] = from_reference(self.code.view(np.uint32),
                                               device)
        return t


def _words(node: Node) -> int:
    return 5 if node.is_ext else 1


def compile_program(pb: ProgramBuilder) -> Program:
    """Schedule, allocate and encode a builder's nodes and constraints."""
    k = len(pb.collected)
    # alpha^(K-1-i) for constraint i: alpha^0 is the immediate one
    pows = [pb.imm(bb.R1)]
    for _ in range(k - 1):
        pows.append(pows[-1] * pb.alpha)

    # the nodes every constraint needs, in creation order (operands first)
    needed = set()
    stack = list(pb.collected) + pows[:k]
    while stack:
        n = stack.pop()
        if n.id in needed:
            continue
        needed.add(n.id)
        if n.kind == "op":
            stack.extend(n.args)
    order = [n for n in pb.nodes if n.id in needed]

    # uniform words: every uniform input or operation gets its own
    uni_at, uni_words, uniform_code = {}, 0, []

    def operand(n: Node):
        if n.kind == "imm":
            return K_IMM, n.args
        if n.kind in _LEAF_KINDS:
            return _LEAF_KINDS[n.kind], n.args
        if n.uniform:
            return K_UNI, uni_at[n.id]
        return K_SLOT, slot_at[n.id]

    for n in order:
        if not n.uniform or n.kind == "imm":
            continue
        uni_at[n.id] = uni_words
        uni_words += _words(n)
        if n.kind == "input":
            uniform_code.append((encode_code(OP_LOAD, True, False, True,
                                             K_INPUT, K_IMM),
                                 uni_at[n.id], n.args, 0))
            continue
        uniform_code.append(_encode_op(n, uni_at[n.id], True, operand))

    # the row program: operations in creation order, each constraint's
    # ACC right after its last operand is made
    row_ops = [n for n in order if n.kind == "op" and not n.uniform]
    acc_after = {}
    for i, c in enumerate(pb.collected):
        anchor = c.id if (c.kind == "op" and not c.uniform) else -1
        acc_after.setdefault(anchor, []).append(i)
    events = [("acc", i) for i in acc_after.get(-1, [])]
    for n in row_ops:
        events.append(("op", n))
        events.extend(("acc", i) for i in acc_after.get(n.id, []))

    # last use of each row value, in event positions
    last_use = {}
    for pos, (what, x) in enumerate(events):
        for a in (x.args if what == "op" else (pb.collected[x],)):
            if a.kind == "op" and not a.uniform:
                last_use[a.id] = pos

    slot_at, free, top = {}, [], 0
    row_code, forms = [], {}

    def alloc(size: int) -> int:
        """First fit among the free words, else at the top (taking the
        free words that end there)."""
        nonlocal top
        free.sort()
        for j in range(len(free) - size + 1):
            if free[j + size - 1] - free[j] == size - 1:
                start = free[j]
                del free[j:j + size]
                return start
        run = 0
        while run < len(free) and free[-1 - run] == top - 1 - run:
            run += 1
        del free[len(free) - run:]
        start = top - run
        top = start + size
        return start

    def release(n: Node):
        start = slot_at[n.id]
        free.extend(range(start, start + _words(n)))

    def row_value(n: Node) -> bool:
        return n.kind == "op" and not n.uniform

    for pos, (what, x) in enumerate(events):
        if what == "acc":
            c, p = pb.collected[x], pows[k - 1 - x]
            ka, ia = operand(c)
            kb, ib = operand(p)
            row_code.append((encode_code(OP_ACC, c.is_ext, p.is_ext, False,
                                         ka, kb), 0, ia, ib))
            key = ("acc", c.is_ext, p.is_ext)
            forms[key] = forms.get(key, 0) + 1
            if row_value(c) and last_use[c.id] == pos:
                release(c)
            continue
        # the operands that die here free their words first, so that the
        # result may take them (the kernel reads both before it writes)
        for a in {a.id: a for a in x.args}.values():
            if row_value(a) and last_use[a.id] == pos:
                release(a)
        slot_at[x.id] = alloc(_words(x))
        row_code.append(_encode_op(x, slot_at[x.id], False, operand))
        key = (x.op,) + tuple(a.is_ext for a in x.args)
        forms[key] = forms.get(key, 0) + 1

    rows = uniform_code + row_code
    code = np.array(rows, dtype=np.int64).reshape(-1, 4).astype(np.int32)
    return Program(code, len(uniform_code), uni_words, top, pb.widths, k,
                   forms)


def _encode_op(n: Node, dst: int, dst_uni: bool, operand) -> tuple:
    op = {"add": OP_ADD, "sub": OP_SUB, "mul": OP_MUL, "neg": OP_NEG}[n.op]
    a = n.args[0]
    b = n.args[1] if len(n.args) > 1 else None
    ka, ia = operand(a)
    kb, ib = operand(b) if b is not None else (K_IMM, 0)
    return (encode_code(op, a.is_ext, b is not None and b.is_ext, dst_uni,
                        ka, kb), dst, ia, ib)


_PROGRAMS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def chip_program(machine, chip, log_degree: int) -> Program:
    """The chip's program at `log_degree` (which enters `eval` through
    `trace_height`), built once per chip object, log_degree and machine."""
    per_chip = _PROGRAMS.setdefault(chip, {})
    key = (log_degree, id(machine))
    prog = per_chip.get(key)
    if prog is None:
        pb = ProgramBuilder(machine, chip, log_degree)
        chip.eval(pb)
        eval_permutation_constraints(chip, pb, pb.cumulative_sum)
        prog = per_chip[key] = compile_program(pb)
    return prog
