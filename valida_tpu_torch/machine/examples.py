"""Small example machines.

Counterpart of valida_tpu/machine/examples.py.  MiniMachine is the
"minimum end-to-end slice": a two-chip machine (sender + range table) with
a global bus lookup, exercising the full prove/verify pipeline — trace
commit, LogUp permutation traces, quotient evaluation, FRI openings, OOD
check, cumulative-sum balance — without the VM layer.  RaggedMachine adds
a second sender of another height and a 1-row chip.

The random machines draw from `np.random.default_rng(seed)` exactly as the
JAX package's do, so one seed gives the same machine (and the same traces)
in both packages.  Pairs are kept as one [n, 2] array and the traces and
range counts are built from it at once, so 2^20 pairs cost no Python loop.
"""

from __future__ import annotations

import numpy as np

from ..air.types import GLOBAL, Bus, Interaction, VPCol
from ..chips.chip import Chip, IndexAllocator, pad_to_power_of_two
from .machine import Machine

RANGE_BUS = Bus(GLOBAL, 0)
MAX = 16  # 4-bit range table


def _pairs_array(pairs) -> np.ndarray:
    return np.asarray(pairs, dtype=np.int64).reshape(-1, 2)


def _range_counts(*values) -> dict:
    """{value: multiplicity} of the values that occur."""
    counts = np.bincount(np.concatenate([np.ravel(v) for v in values]),
                         minlength=MAX)
    return {v: int(c) for v, c in enumerate(counts) if c}


class SenderChip(Chip):
    """Rows of nibble pairs (a, b) with witnessed sum; sends a and b to the
    range bus, constrained a + b == c."""

    name = "sender"
    alloc = IndexAllocator()
    A = alloc.scalar()
    B = alloc.scalar()
    C = alloc.scalar()
    IS_REAL = alloc.scalar()
    WIDTH = alloc.width

    def __init__(self, pairs):
        self.pairs = _pairs_array(pairs)  # [n, 2]

    def width(self):
        return self.WIDTH

    def generate_trace(self, machine):
        a, b = self.pairs[:, 0], self.pairs[:, 1]
        rows = np.stack([a, b, a + b, np.ones_like(a)], axis=1)
        return pad_to_power_of_two(rows.astype(np.uint32))

    def global_sends(self, machine):
        return [
            Interaction(fields=[VPCol.single_main(self.A)],
                        count=VPCol.single_main(self.IS_REAL),
                        bus=machine.range_bus()),
            Interaction(fields=[VPCol.single_main(self.B)],
                        count=VPCol.single_main(self.IS_REAL),
                        bus=machine.range_bus()),
        ]

    def eval(self, b):
        local = b.main_local
        b.assert_zero(
            local[self.IS_REAL] * (local[self.A] + local[self.B] - local[self.C])
        )
        b.assert_bool(local[self.IS_REAL])


class RangeChip(Chip):
    """Range table 0..MAX with main counter + multiplicity and a
    preprocessed counter column (exercising preprocessed commits)."""

    name = "range"

    def __init__(self):
        self.counts = {}

    def width(self):
        return 2

    def generate_trace(self, machine):
        rows = np.zeros((MAX, 2), dtype=np.uint32)
        for v, c in self.counts.items():
            rows[v, 0] = c
        rows[:, 1] = np.arange(MAX)
        return rows

    def preprocessed_trace(self):
        return np.arange(MAX, dtype=np.uint32).reshape(MAX, 1)

    def global_receives(self, machine):
        return [
            Interaction(fields=[VPCol.single_main(1)],
                        count=VPCol.single_main(0),
                        bus=machine.range_bus()),
        ]

    def eval(self, b):
        # main counter equals the preprocessed counter
        b.assert_eq(b.main_local[1], b.preprocessed_local[0])


class MiniMachine(Machine):
    def __init__(self, pairs):
        self.sender = SenderChip(pairs)
        self.range = RangeChip()
        self.range.counts = _range_counts(self.sender.pairs)

    def chips(self):
        return [self.sender, self.range]

    def range_bus(self):
        return RANGE_BUS


def random_mini_machine(n_pairs: int, seed: int = 0) -> MiniMachine:
    rng = np.random.default_rng(seed)
    return MiniMachine(rng.integers(0, MAX, size=(n_pairs, 2)))


class Sender2Chip(SenderChip):
    """Second sender with its own (smaller) height — distinct name so the
    two senders are separate chips in the proof."""

    name = "sender2"


class OneRowChip(Chip):
    """Single-row chip: sends its one value to the range bus.  Exercises
    the log_degree-0 commit / 2-row-LDE / opening path."""

    name = "onerow"

    def __init__(self, value: int):
        self.value = value

    def width(self):
        return 2

    def generate_trace(self, machine):
        return np.array([[self.value, 1]], dtype=np.uint32)

    def global_sends(self, machine):
        return [
            Interaction(fields=[VPCol.single_main(0)],
                        count=VPCol.single_main(1),
                        bus=machine.range_bus()),
        ]

    def eval(self, b):
        b.assert_bool(b.main_local[1])


class RaggedMachine(Machine):
    """4 heterogeneous chips (heights n, n//8, 16, 1), a preprocessed
    matrix, one global bus: ragged trace heights, a preprocessed commit and
    a 1-row trace in one proof."""

    def __init__(self, pairs, pairs2, one_value: int):
        self.sender = SenderChip(pairs)
        self.sender2 = Sender2Chip(pairs2)
        self.onerow = OneRowChip(one_value)
        self.range = RangeChip()
        self.range.counts = _range_counts(self.sender.pairs,
                                          self.sender2.pairs, [one_value])

    def chips(self):
        return [self.sender, self.sender2, self.range, self.onerow]

    def range_bus(self):
        return RANGE_BUS


def random_ragged_machine(n_pairs: int, seed: int = 0) -> RaggedMachine:
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, MAX, size=(n_pairs, 2))
    pairs2 = rng.integers(0, MAX, size=(max(n_pairs // 8, 1), 2))
    return RaggedMachine(pairs, pairs2, int(rng.integers(0, MAX)))


# ---------------------------------------------------------------------------
# BasicMachine programs
# ---------------------------------------------------------------------------


def instruction(opcode, a=0, b=0, c=0, d=0, e=0):
    from ..core.program import InstructionWord, Operands

    return InstructionWord(opcode, Operands((a, b, c, d, e)))


def fib_program() -> list:
    """Hand-assembled fib(25), the Rust reference's
    `basic/tests/test_prover.rs:35-188` (the JAX package's
    tests/test_basic_machine.py): 192 cycles, fib(25) = 75025 at fp + 4."""
    from ..core import opcodes as OC

    B = OC.BYTES_PER_INSTR
    fib_bb0, fib_bb0_1, fib_bb0_2 = 8 * B, 13 * B, 15 * B
    fib_bb0_3, fib_bb0_4 = 19 * B, 21 * B
    return [
        # main
        instruction(OC.IMM32, -4, 0, 0, 0, 0),
        instruction(OC.IMM32, -8, 0, 0, 0, 25),
        instruction(OC.ADD32, -16, -8, 0, 0, 1),
        instruction(OC.IMM32, -20, 0, 0, 0, 28),
        instruction(OC.JAL, -28, fib_bb0, -28, 0, 0),
        instruction(OC.ADD32, -12, -24, 0, 0, 1),
        instruction(OC.ADD32, 4, -12, 0, 0, 1),
        instruction(OC.STOP),
        # fib:
        instruction(OC.ADD32, -4, 12, 0, 0, 1),
        instruction(OC.IMM32, -8, 0, 0, 0, 0),
        instruction(OC.IMM32, -12, 0, 0, 0, 1),
        instruction(OC.IMM32, -16, 0, 0, 0, 0),
        instruction(OC.BEQ, fib_bb0_1, 0, 0, 0, 0),
        # .LBB0_1:
        instruction(OC.BNE, fib_bb0_2, -16, -4, 0, 0),
        instruction(OC.BEQ, fib_bb0_4, 0, 0, 0, 0),
        # .LBB0_2:
        instruction(OC.ADD32, -20, -8, -12, 0, 0),
        instruction(OC.ADD32, -8, -12, 0, 0, 1),
        instruction(OC.ADD32, -12, -20, 0, 0, 1),
        instruction(OC.BEQ, fib_bb0_3, 0, 0, 0, 0),
        # .LBB0_3:
        instruction(OC.ADD32, -16, -16, 1, 0, 1),
        instruction(OC.BEQ, fib_bb0_1, 0, 0, 0, 0),
        # .LBB0_4:
        instruction(OC.ADD32, 4, -8, 0, 0, 1),
        instruction(OC.JALV, -4, 0, 8, 0, 0),
    ]


def alu_loop_program(n_iters: int) -> list:
    """A loop over the whole u32 ALU (add, mul, xor, and, or, sub, div,
    shl, shr, lt, eq, sle, then bne): 13 cycles an iteration, the JAX
    package's benchmarks/big_trace.py workload ("alu_u32 full ISA trace";
    `n_iters = 2**log_cycles // 14` fills 2^log_cycles rows)."""
    from ..core import opcodes as OC

    loop_start = 3 * OC.BYTES_PER_INSTR
    return [
        instruction(OC.IMM32, -4, 0, 0, 0, 0),      # counter
        instruction(OC.IMM32, -8, 0, 0, 0, 3),
        instruction(OC.IMM32, -12, 0, 1, 0, 1),     # 65537
        # loop:
        instruction(OC.ADD32, -4, -4, 1, 0, 1),
        instruction(OC.MUL32, -16, -4, -12, 0, 0),
        instruction(OC.XOR32, -20, -16, -4, 0, 0),
        instruction(OC.AND32, -24, -16, -12, 0, 0),
        instruction(OC.OR32, -28, -20, -24, 0, 0),
        instruction(OC.SUB32, -32, -16, -4, 0, 0),
        instruction(OC.DIV32, -36, -16, -8, 0, 0),
        instruction(OC.SHL32, -40, -4, 3, 0, 1),
        instruction(OC.SHR32, -44, -16, 2, 0, 1),
        instruction(OC.LT32, -48, -4, n_iters, 0, 1),
        instruction(OC.EQ32, -52, -4, -8, 0, 0),
        instruction(OC.SLE32, -56, -32, -16, 0, 0),
        instruction(OC.BNE, loop_start, -48, 0, 0, 1),
        instruction(OC.STOP),
    ]


def run_program(program, fp: int, static_data=None):
    """A BasicMachine that has run `program` (a list of InstructionWords)
    from pc 0 with frame pointer `fp`, static data {address: word} loaded
    and an empty advice tape: ready to prove."""
    from ..core.advice import FixedAdviceProvider
    from ..core.program import ProgramROM
    from .basic import BasicMachine

    m = BasicMachine()
    m.program().set_program_rom(ProgramROM(list(program)))
    for addr, value in (static_data or {}).items():
        m.static_data().write(addr, value)
    m.cpu().fp = fp
    m.cpu().registers.append((m.cpu().pc, m.cpu().fp))
    m.run(advice=FixedAdviceProvider.empty())
    return m
