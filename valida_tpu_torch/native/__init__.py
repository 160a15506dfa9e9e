"""ctypes bindings of the native interpreter core (interpreter.cpp).

Counterpart of valida_tpu/native/__init__.py.  `run_native(machine)`
executes the machine's loaded program with the C++ VM and fills its chips'
state as the Python interpreter (`BasicMachine.run`) would.  With
build_lists=False the op logs are handed over as numpy arrays
(`CpuChip.ops_arrays`, `MemoryChip.ops_arrays`, a 4-tuple of arrays as an
ALU chip's `operations`) and the Python lists stay empty; the trace
builders read the arrays.

There is no fallback: if the library cannot be built or loaded,
`run_native` raises `NativeRunError`.  The library is built by g++ at its
first use (native/build.py), never when this module is imported.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..chips.cpu import KIND_CODE
from ..core import opcodes as OC

_P = ctypes.c_void_p
_SIZE = ctypes.c_size_t
# C entry -> (restype, argtypes)
_SIGNATURES = {
    "vm_create": (_P, [ctypes.c_char_p, _SIZE, ctypes.c_uint32,
                       ctypes.c_uint32]),
    "vm_set_static": (None, [_P, _P, _P, _SIZE]),
    "vm_set_advice": (None, [_P, _P, _SIZE]),
    "vm_run": (ctypes.c_int, [_P, ctypes.c_uint64]),
    "vm_error": (ctypes.c_char_p, [_P]),
    "vm_clock": (ctypes.c_uint64, [_P]),
    "vm_pc": (ctypes.c_uint32, [_P]),
    "vm_fp": (ctypes.c_uint32, [_P]),
    "vm_num_cpu_ops": (_SIZE, [_P]),
    "vm_copy_cpu_ops": (None, [_P] * 8),
    "vm_num_mem_ops": (_SIZE, [_P]),
    "vm_copy_mem_ops": (None, [_P] * 5),
    "vm_copy_range_counts": (None, [_P, _P]),
    "vm_num_program_counts": (_SIZE, [_P]),
    "vm_copy_program_counts": (None, [_P, _P]),
    "vm_num_outputs": (_SIZE, [_P]),
    "vm_copy_outputs": (None, [_P, _P, _P]),
    "vm_num_cells": (_SIZE, [_P]),
    "vm_copy_cells": (None, [_P, _P, _P]),
    "vm_free": (None, [_P]),
}

# kind code -> the CPU log's kind name
_CPU_KINDS = list(KIND_CODE)

# the VM's ALU logs: (chip accessor, the kind names of its (kind, a, b, c)
# records; None for a chip of one kind, whose list records are (a, b, c))
ALU_LOGS = {
    "add_ops": ("add_u32", None),
    "sub_ops": ("sub_u32", None),
    "mul_ops": ("mul_u32", ["mul", "mulhs", "mulhu"]),
    "div_ops": ("div_u32", ["div", "sdiv"]),
    "lt_ops": ("lt_u32", ["lt", "lte", "slt", "sle"]),
    "com_ops": ("com_u32", ["ne", "eq"]),
    "bitwise_ops": ("bitwise_u32", ["and", "or", "xor"]),
    "shift_ops": ("shift_u32", ["shl", "shr", "sra"]),
    "nf_ops": ("native_field", ["add", "sub", "mul"]),
}
for _name in ALU_LOGS:
    _SIGNATURES[f"vm_num_{_name}"] = (_SIZE, [_P])
    _SIGNATURES[f"vm_copy_{_name}"] = (None, [_P] * 5)

_LIB = None


class NativeRunError(RuntimeError):
    pass


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from .build import build

        lib = ctypes.CDLL(str(build()))
        for fn, (restype, argtypes) in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _LIB = lib
    return _LIB


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_P)


def _copy(lib, vm, fn, *shapes_dtypes):
    """Allocate one array per (shape, dtype), let C entry `fn` fill them."""
    arrays = [np.zeros(shape, dtype=dt) for shape, dt in shapes_dtypes]
    getattr(lib, fn)(vm, *(_ptr(a) for a in arrays))
    return arrays


def run_native(machine, max_steps: int = 1 << 32, build_lists: bool = True,
               advice: bytes = b"") -> None:
    """Execute `machine`'s loaded program with the C++ core, from its CPU's
    pc and fp, with `advice` as the advice tape, and fill its chips' state:
    op logs, memory cells, range and program counts, outputs.

    Raises NativeRunError if the library is unavailable, the VM fails (with
    the VM's message), or an executed opcode is not in the machine's ISA
    (`type(machine).DISPATCH`)."""
    try:
        lib = _load()
    except (OSError, RuntimeError) as e:
        raise NativeRunError(f"native interpreter unavailable: {e}") from e

    from ..core.program import InstructionWord, Operands

    code = machine.program().program_rom.to_machine_code()
    cpu, mem = machine.cpu(), machine.mem()
    pc0, fp0 = cpu.pc, cpu.fp
    vm = _P(lib.vm_create(code, len(code), pc0, fp0))
    try:
        static = machine.static_data().cells
        if static:
            addrs = np.fromiter(static.keys(), dtype=np.uint32)
            vals = np.fromiter(static.values(), dtype=np.uint32)
            lib.vm_set_static(vm, _ptr(addrs), _ptr(vals), len(addrs))
            for a, v in static.items():
                mem.write_static(a, v)
        # the VM reads the advice buffer during vm_run: `adv` outlives it
        adv = np.frombuffer(advice, dtype=np.uint8)
        if len(adv):
            lib.vm_set_advice(vm, _ptr(adv), len(adv))

        failed = lib.vm_run(vm, max_steps) != 0

        # -- cpu ops ----------------------------------------------------
        n = int(lib.vm_num_cpu_ops(vm))
        kind, has_imm, imm, opcode, operands, pcs, fps = _copy(
            lib, vm, "vm_copy_cpu_ops", (n, np.uint8), (n, np.uint8),
            (n, np.uint32), (n, np.uint32), ((n, 5), np.int32),
            (n, np.uint32), (n, np.uint32))
        # the VM runs the whole ISA; the machine may have a smaller one.
        # Raise where `run` would: at the first executed opcode outside it
        # (the VM stops at a failing instruction without logging it)
        executed = opcode
        rom = machine.program().program_rom
        if failed and int(lib.vm_pc(vm)) < len(rom):
            executed = np.append(
                opcode, rom.get_instruction(int(lib.vm_pc(vm))).opcode)
        allowed = list(type(machine).DISPATCH) + [OC.READ_ADVICE]
        outside = ~np.isin(executed, allowed)
        if outside.any():
            raise NativeRunError(
                f"Unrecognized opcode: {int(executed[outside.argmax()])}")
        if failed:
            raise NativeRunError(lib.vm_error(vm).decode())
        if build_lists:
            cpu.operations = [
                (_CPU_KINDS[k], im if h else None)
                for k, h, im in zip(kind.tolist(), has_imm.tolist(),
                                    imm.tolist())]
            cpu.instructions = [
                InstructionWord(oc, Operands(tuple(o)))
                for oc, o in zip(opcode.tolist(), operands.tolist())]
            cpu.registers = [(pc0, fp0)] + list(zip(pcs.tolist(),
                                                    fps.tolist()))
        else:
            # the VM records each op's registers after it ran: the state
            # before op i is the initial one, then the state after op i - 1
            pre_pc = np.empty(n, dtype=np.uint32)
            pre_fp = np.empty(n, dtype=np.uint32)
            if n:
                pre_pc[0], pre_fp[0] = pc0, fp0
                pre_pc[1:], pre_fp[1:] = pcs[:-1], fps[:-1]
            cpu.operations, cpu.instructions, cpu.registers = [], [], []
            cpu.ops_arrays = (kind, has_imm, imm, opcode, operands, pre_pc,
                              pre_fp)
        cpu.clock = int(lib.vm_clock(vm))
        cpu.pc = int(lib.vm_pc(vm))
        cpu.fp = int(lib.vm_fp(vm))

        # -- memory ops, in execution order -----------------------------
        n = int(lib.vm_num_mem_ops(vm))
        clk, is_write, addr, value = _copy(
            lib, vm, "vm_copy_mem_ops", (n, np.uint32), (n, np.uint8),
            (n, np.uint32), (n, np.uint32))
        if build_lists:
            ops: dict[int, list] = {}
            for ck, w, ad, vl in zip(clk.tolist(), is_write.tolist(),
                                     addr.tolist(), value.tolist()):
                ops.setdefault(ck, []).append(("w" if w else "r", ad, vl))
            mem.operations = ops
        else:
            mem.operations = {}
            mem.ops_arrays = (clk, is_write, addr, value)
        n = int(lib.vm_num_cells(vm))
        addrs, vals = _copy(lib, vm, "vm_copy_cells", (n, np.uint32),
                            (n, np.uint32))
        mem.cells = dict(zip(addrs.tolist(), vals.tolist()))

        # -- ALU chips --------------------------------------------------
        for name, (accessor, kinds) in ALU_LOGS.items():
            if not hasattr(machine, accessor):
                continue  # its opcodes were rejected above
            n = int(getattr(lib, f"vm_num_{name}")(vm))
            k, a, b, c = _copy(lib, vm, f"vm_copy_{name}",
                               *[(n, np.uint32)] * 4)
            if not build_lists:
                ops = (k, a, b, c)
            elif kinds is None:
                ops = list(zip(a.tolist(), b.tolist(), c.tolist()))
            else:
                ops = [(kinds[ki], ai, bi, ci) for ki, ai, bi, ci in
                       zip(k.tolist(), a.tolist(), b.tolist(), c.tolist())]
            getattr(machine, accessor)().operations = ops

        # -- counts, outputs --------------------------------------------
        (rc,) = _copy(lib, vm, "vm_copy_range_counts", (256, np.uint32))
        machine.range().count = {i: c for i, c in enumerate(rc.tolist())
                                 if c}
        n = int(lib.vm_num_program_counts(vm))
        (counts,) = _copy(lib, vm, "vm_copy_program_counts",
                          (n, np.uint32))
        machine.program().counts = counts.tolist()
        n = int(lib.vm_num_outputs(vm))
        oclk, oval = _copy(lib, vm, "vm_copy_outputs", (n, np.uint64),
                           (n, np.uint32))
        machine.output().values = list(zip(oclk.tolist(), oval.tolist()))
    finally:
        lib.vm_free(vm)
