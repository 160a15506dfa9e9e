"""Alternative machine compositions from the same chip set.

The reference proves its composition layer is generic by building the
same machine twice (hand-rolled `basic/src/lib.rs:66-124` vs derive-macro
`basic_macro/src/lib.rs:54-160`).  The analogue here: DIFFERENT machines
assembled from the same chips and the same prove/verify pipeline —

* `ExtendedMachine` — BasicMachine + the NativeFieldChip
  (`native_field/src/lib.rs:36-106`), wiring FADD/FSUB/FMUL (opcodes
  200-202, `opcodes/src/lib.rs:30-33`) end to end: dispatch, trace, AIR,
  general/range bus traffic.  The C++ interpreter executes these ops
  (`native/interpreter.cpp`), so run_native works unchanged, in both
  modes.
* `LoadStoreMachine` — a CPU+memory machine with NO ALU chips: programs
  restricted to loads/stores/branches/jumps/imm32/write.  The general
  bus carries only WRITE traffic (received by the output chip); the
  memory/range/byte buses balance exactly as in BasicMachine.

Both are proved/verified by the generic pipeline untouched.  Counterpart
of valida_tpu/machine/compositions.py (tests/test_torch_compositions.py).
"""

from __future__ import annotations

from ..core import opcodes as OC
from ..chips.native_field import NativeFieldChip, ex_fadd, ex_fsub, ex_fmul
from .basic import BasicMachine, _DISPATCH


class ExtendedMachine(BasicMachine):
    """BasicMachine + NativeFieldChip (16 chips)."""

    DISPATCH = {
        **_DISPATCH,
        OC.ADD: ex_fadd,
        OC.SUB: ex_fsub,
        OC.MUL: ex_fmul,
    }

    def __init__(self):
        super().__init__()
        self._native_field = NativeFieldChip()

    def native_field(self):
        return self._native_field

    def chips(self):
        return super().chips() + [self._native_field]


_LOADSTORE_OPS = (
    OC.LOAD32, OC.LOADU8, OC.LOADS8, OC.STORE32, OC.STOREU8,
    OC.JAL, OC.JALV, OC.BEQ, OC.BNE, OC.IMM32, OC.STOP, OC.LOADFP,
    OC.WRITE,
)


class LoadStoreMachine(BasicMachine):
    """CPU + memory + output machine with no ALU chips (7 chips).

    Demonstrates that chips compose freely: removing the ALU chips
    removes their bus endpoints symmetrically, so every bus still
    balances for programs within the reduced ISA.  Executing an ALU
    opcode raises (no silent imbalance), under `run` and `run_native`."""

    DISPATCH = {
        op: _DISPATCH[op] for op in _LOADSTORE_OPS
    }

    def chips(self):
        return [
            self._cpu, self._program, self._mem, self._output, self._range,
            self._static_data, self._byte,
        ]
