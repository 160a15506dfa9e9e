"""The port's native interpreter (valida_tpu_torch.native, the C++ core
built with g++ at first use) against the JAX package's Python interpreter:
`BasicMachine.run_native()` in list mode leaves the chip state the JAX
package's `run` leaves, word for word; in array mode
(build_lists=False) every chip's trace equals the JAX package's
`generate_trace`, and a proof made from it has the JAX package's bytes.
The models are tests/test_native_interpreter.py and
tests/test_interpreter.py."""

import hashlib

import numpy as np
import pytest
import torch

from valida_tpu.core.advice import FixedAdviceProvider as RAdvice
from valida_tpu.core.program import InstructionWord as RIW
from valida_tpu.core.program import Operands as ROperands
from valida_tpu.core.program import ProgramROM as RROM
from valida_tpu.machine.basic import BasicMachine as RBasicMachine
from valida_tpu_torch import native
from valida_tpu_torch.chips.chip import trace_on
from valida_tpu_torch.chips.memory import SameClkReadAfterWrite
from valida_tpu_torch.convert import to_numpy
from valida_tpu_torch.core import config
from valida_tpu_torch.core import opcodes as OC
from valida_tpu_torch.core.advice import FixedAdviceProvider
from valida_tpu_torch.core.program import ProgramROM
from valida_tpu_torch.machine import examples
from valida_tpu_torch.machine.basic import BasicMachine
from valida_tpu_torch.native import build as native_build
from valida_tpu_torch.tooling import serde


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's CPU
    operations on one thread each keep them from crowding the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _iw(opcode, a=0, b=0, c=0, d=0, e=0):
    return (opcode, (a, b, c, d, e))


# tests/test_native_interpreter.py's ALU_PROGRAM and the advice/byte-op
# program of its test_native_matches_python_advice_and_bytes, as
# (opcode, operands) rows, with their static data and advice
PROGRAMS = {
    "alu": ([
        _iw(OC.IMM32, -4, 0, 0, 0, 100),
        _iw(OC.IMM32, -8, 0, 0, 0, 7),
        _iw(OC.MUL32, -12, -4, -8, 0, 0),
        _iw(OC.DIV32, -16, -12, -8, 0, 0),
        _iw(OC.SHL32, -20, -8, 2, 0, 1),
        _iw(OC.SHR32, -24, -4, 3, 0, 1),
        _iw(OC.AND32, -28, -4, -8, 0, 0),
        _iw(OC.OR32, -32, -4, -8, 0, 0),
        _iw(OC.XOR32, -36, -4, -8, 0, 0),
        _iw(OC.EQ32, -40, -4, -8, 0, 0),
        _iw(OC.NE32, -44, -4, -8, 0, 0),
        _iw(OC.SUB32, -48, -4, -8, 0, 0),
        _iw(OC.MULHU32, -52, -4, -8, 0, 0),
        _iw(OC.MULHS32, -60, -4, -8, 0, 0),
        _iw(OC.SRA32, -56, -4, 4, 0, 1),
        _iw(OC.SLT32, -64, -4, -8, 0, 0),
        _iw(OC.SLE32, -68, -4, -8, 0, 0),
        _iw(OC.LT32, -72, 3, -8, 1, 0),
        _iw(OC.LOADFP, -76, 5, 0, 0, 0),
        _iw(OC.SDIV32, -80, -4, -8, 0, 0),
        _iw(OC.IMM32, -84, 255, 255, 255, 156),
        _iw(OC.IMM32, -88, 255, 255, 255, 249),
        _iw(OC.SDIV32, -92, -84, -8, 0, 0),
        _iw(OC.SDIV32, -96, -84, -88, 0, 0),
        _iw(OC.SDIV32, -100, -4, -88, 0, 0),
        _iw(OC.SRA32, -104, -84, 3, 0, 1),
        _iw(OC.MULHS32, -108, -84, -8, 0, 0),
        _iw(OC.MULHS32, -112, -84, -88, 0, 0),
        _iw(OC.MULHU32, -116, -84, -88, 0, 0),
        _iw(OC.WRITE, 0, -8, 0, 0, 1),
        _iw(OC.STOP),
    ], None, b""),
    "advice_bytes": ([
        _iw(OC.READ_ADVICE, -4, 0, 0, 0, 0),
        _iw(OC.READ_ADVICE, -8, 0, 0, 0, 0),
        _iw(OC.READ_ADVICE, -12, 0, 0, 0, 0),
        _iw(OC.IMM32, -16, 0, 0, 1, 1),
        _iw(OC.STOREU8, 0, -16, -4, 0, 0),
        _iw(OC.LOADU8, -20, 0, -16, 0, 0),
        _iw(OC.LOADS8, -24, 0, -16, 0, 0),
        _iw(OC.STOP),
    ], {0x110: 0xAABBCCDD}, bytes([7, 9])),
}


def _rows(name):
    if name == "fib":
        return ([(iw.opcode, iw.operands.ops)
                 for iw in examples.fib_program()], None, b"")
    return PROGRAMS[name]


def ref_run(name):
    """The JAX package's BasicMachine after its Python `run`, fp 0x1000."""
    rows, static, advice = _rows(name)
    m = RBasicMachine()
    m.program().set_program_rom(RROM([RIW(op, ROperands(ops))
                                      for op, ops in rows]))
    for addr, value in (static or {}).items():
        m.static_data().write(addr, value)
    m.cpu().fp = 0x1000
    m.cpu().registers.append((m.cpu().pc, m.cpu().fp))
    m.run(advice=RAdvice(advice))
    return m


def port_native(name, build_lists):
    """The port's BasicMachine after run_native, fp 0x1000."""
    rows, static, advice = _rows(name)
    m = BasicMachine()
    m.program().set_program_rom(ProgramROM(
        [examples.instruction(op, *ops) for op, ops in rows]))
    for addr, value in (static or {}).items():
        m.static_data().write(addr, value)
    m.cpu().fp = 0x1000
    m.cpu().registers.append((m.cpu().pc, m.cpu().fp))
    m.run_native(advice_bytes=advice, build_lists=build_lists)
    return m


ALU_CHIPS = ["add_u32", "sub_u32", "mul_u32", "div_u32", "lt_u32",
             "com_u32", "bitwise_u32", "shift_u32"]
NAMES = ["fib", "alu", "advice_bytes"]


@pytest.fixture(scope="module")
def machines():
    """{program: (JAX package's run, port's list mode, port's array
    mode)}."""
    return {name: (ref_run(name), port_native(name, True),
                   port_native(name, False)) for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_list_mode_matches_reference_run(machines, name):
    ref, m, _ = machines[name]
    assert m.cpu().clock == ref.cpu().clock > 0
    assert (m.cpu().pc, m.cpu().fp) == (ref.cpu().pc, ref.cpu().fp)
    assert m.cpu().operations == ref.cpu().operations
    assert [(i.opcode, tuple(i.operands.ops)) for i in m.cpu().instructions] \
        == [(i.opcode, tuple(i.operands.ops)) for i in ref.cpu().instructions]
    assert m.cpu().registers == ref.cpu().registers
    assert m.mem().cells == ref.mem().cells
    assert m.mem().operations == ref.mem().operations
    for acc in ALU_CHIPS:
        assert getattr(m, acc)().operations == \
            getattr(ref, acc)().operations, acc
    assert m.range().count == ref.range().count
    assert m.program().counts == ref.program().counts
    assert m.output().values == ref.output().values


def test_fib_profile():
    """`basic/tests/test_prover.rs:473-487` from the native core: clock
    192, 401 memory operations, 105 adds, fib(25) = 75025 at fp + 4."""
    m = port_native("fib", False)
    assert m.cpu().clock == 192
    assert len(m.mem().op_arrays()[0]) == 401
    assert len(m.add_u32().operations[1]) == 105
    assert m.mem().cells[0x1000 + 4] == 75025


CHIPS = ["cpu", "program", "mem", "add_u32", "sub_u32", "mul_u32", "div_u32",
         "shift_u32", "lt_u32", "com_u32", "bitwise_u32", "output", "range",
         "static_data", "byte"]


@pytest.mark.parametrize("name, chip_name",
                         [(n, c) for n in NAMES for c in CHIPS])
def test_array_mode_trace_matches_reference(machines, name, chip_name):
    """Array mode keeps no Python logs, and every chip's trace, built from
    the op arrays, equals the JAX package's `generate_trace` after its
    `run`."""
    ref, _, m = machines[name]
    assert m.cpu().operations == m.cpu().instructions == []
    assert m.cpu().registers == [] and m.mem().operations == {}
    rc = next(c for c in ref.chips() if c.name == chip_name)
    pc = next(c for c in m.chips() if c.name == chip_name)
    want = np.asarray(rc.generate_trace(ref), dtype=np.uint32)
    np.testing.assert_array_equal(to_numpy(trace_on(pc, m, "cpu")), want,
                                  err_msg=chip_name)


@pytest.mark.parametrize("name", NAMES)
def test_op_arrays_match_list_mode(machines, name):
    """The CPU's and the memory's op arrays from the native core equal
    those made from the list mode's logs (dtypes too); each ALU chip's
    array 4-tuple equals its list converted."""
    from valida_tpu_torch.chips.alu import _ops_to_arrays
    from valida_tpu_torch.native import ALU_LOGS

    _, lists, arrays = machines[name]
    for chip in ("cpu", "mem"):
        got = getattr(arrays, chip)().op_arrays()
        want = getattr(lists, chip)().op_arrays()
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    for accessor, kinds in ALU_LOGS.values():
        if accessor == "native_field":
            continue
        got = getattr(arrays, accessor)().operations
        want = _ops_to_arrays(getattr(lists, accessor)().operations, kinds)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)


def test_fib_proof_from_array_mode():
    """fib(25) interpreted in array mode proves, under default_config() on
    the CPU, into the bytes whose SHA-256 chip_smoke.py pins for path (n)
    (the JAX package's numpy path)."""
    import chip_smoke

    m = port_native("fib", False)
    proof = m.prove(config.default_config(device="cpu"))
    blob = serde.serialize_proof(proof)
    assert hashlib.sha256(blob).hexdigest() == chip_smoke.BASIC_GOLDEN["n"]


@pytest.mark.parametrize("name", NAMES)
def test_array_mode_mem_rows_and_range_counts_match_list_mode(machines, name):
    """Array mode sorts the memory rows and counts their delta limbs in
    the C++ routine (native/memsort.cpp), list mode in numpy: the range
    chip's counts and the memory chip's trace inputs are the same, word
    for word."""
    _, lists, arrays = machines[name]
    assert arrays.mem().ops_arrays is not None
    assert lists.mem().ops_arrays is None
    assert arrays.range().count == lists.range().count
    got, got_meta = arrays.mem().device_trace_inputs(arrays)
    want, want_meta = lists.mem().device_trace_inputs(lists)
    assert got_meta == want_meta
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype == np.uint32
        np.testing.assert_array_equal(g, w)


def test_fib_proof_from_list_mode():
    """fib(25) interpreted in list mode (the memory rows sorted in numpy)
    proves into the same bytes as in array mode: chip_smoke.py's pin for
    path (n)."""
    import chip_smoke

    m = port_native("fib", True)
    proof = m.prove(config.default_config(device="cpu"))
    blob = serde.serialize_proof(proof)
    assert hashlib.sha256(blob).hexdigest() == chip_smoke.BASIC_GOLDEN["n"]


def _jalv_machine():
    """A BasicMachine whose JALV reads the cell it wrote in the same
    cycle (tests/test_interpreter.py's program)."""
    m = BasicMachine()
    m.program().set_program_rom(ProgramROM([
        examples.instruction(OC.IMM32, -4, 0, 0, 0, 48),
        examples.instruction(OC.JALV, -4, -4, -4, 0, 0),
        examples.instruction(OC.STOP),
    ]))
    m.cpu().fp = 0x1000
    m.cpu().registers.append((m.cpu().pc, m.cpu().fp))
    return m


@pytest.mark.parametrize("build_lists", [True, False])
def test_same_clk_read_after_write_raises(build_lists):
    with pytest.raises(SameClkReadAfterWrite, match="same-clk"):
        _jalv_machine().run(advice=FixedAdviceProvider.empty())
    with pytest.raises(native.NativeRunError, match="same-clk"):
        _jalv_machine().run_native(build_lists=build_lists)


def test_large_loop_in_array_mode():
    """The ALU loop at 2^15 cycles runs to its cycle count in array mode
    (no speed is asserted)."""
    m = BasicMachine()
    m.program().set_program_rom(ProgramROM(
        examples.alu_loop_program((1 << 15) // 14)))
    m.cpu().fp = 0x1000000
    m.run_native(build_lists=False)
    n_iters = (1 << 15) // 14
    assert m.cpu().clock == 4 + 13 * n_iters == len(m.cpu().op_arrays()[0])
    # MUL32 and SHL32 each log a mul row
    assert len(m.mul_u32().operations[0]) == 2 * n_iters


def test_no_fallback_when_the_library_is_unavailable(monkeypatch, tmp_path):
    """With the core's source missing (so no library can be built or
    loaded), run_native raises NativeRunError and never runs the Python
    interpreter."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native_build, "SRC", tmp_path / "missing.cpp")

    def no_run(*args, **kwargs):
        raise AssertionError("run_native fell back to run")

    monkeypatch.setattr(BasicMachine, "run", no_run)
    m = BasicMachine()
    m.program().set_program_rom(ProgramROM(examples.fib_program()))
    with pytest.raises(native.NativeRunError, match="unavailable"):
        m.run_native()
    assert m.cpu().clock == 0


def test_build_compiles_the_ports_source(monkeypatch, tmp_path):
    """g++ compiles valida_tpu_torch/native/interpreter.cpp (not the JAX
    package's copy), native/poseidon.cpp, native/memsort.cpp,
    native/memroute.cpp and native/cbor.cpp into one library in
    build/valida_tpu_torch/, to a file named by a hash of the
    sources and the flags, written whole and then renamed."""
    import subprocess
    from pathlib import Path

    import valida_tpu_torch

    pkg = Path(valida_tpu_torch.__file__).resolve().parent
    assert native_build.SRC == pkg / "native" / "interpreter.cpp"
    assert native_build.POSEIDON_SRC == pkg / "native" / "poseidon.cpp"
    assert native_build.MEMSORT_SRC == pkg / "native" / "memsort.cpp"
    assert native_build.MEMROUTE_SRC == pkg / "native" / "memroute.cpp"
    assert native_build.CBOR_SRC == pkg / "native" / "cbor.cpp"
    assert native_build.sources() == (native_build.SRC,
                                      native_build.POSEIDON_SRC,
                                      native_build.MEMSORT_SRC,
                                      native_build.MEMROUTE_SRC,
                                      native_build.CBOR_SRC)
    assert native_build.BUILD_DIR == pkg.parent / "build" / "valida_tpu_torch"
    assert native_build.SRC.read_bytes() != (
        pkg.parent / "valida_tpu" / "native" / "interpreter.cpp").read_bytes()
    commands = []
    real_run = subprocess.run

    def run(cmd, **kwargs):
        commands.append(cmd)
        return real_run(cmd, **kwargs)

    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(subprocess, "run", run)
    lib = native_build.build()
    assert lib == native_build.target() and lib.parent == tmp_path
    assert [p.name for p in tmp_path.iterdir()] == [lib.name]
    (cmd,) = commands
    assert cmd[0] == "g++" and cmd[-5:] == [
        str(src) for src in native_build.sources()]
    assert native_build.build() == lib and len(commands) == 1


SOURCES = ["SRC", "POSEIDON_SRC", "MEMSORT_SRC", "MEMROUTE_SRC", "CBOR_SRC"]


@pytest.mark.parametrize("name", SOURCES)
def test_changing_either_source_changes_the_target(monkeypatch, tmp_path,
                                                    name):
    """The library's name hashes every source: an edit to any one names
    another library, so a stale build never loads."""
    for attr in SOURCES:
        copy = tmp_path / getattr(native_build, attr).name
        copy.write_bytes(getattr(native_build, attr).read_bytes())
        monkeypatch.setattr(native_build, attr, copy)
    before = native_build.target()
    assert before.parent == native_build.BUILD_DIR
    src = getattr(native_build, name)
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    after = native_build.target()
    assert after != before and after.name.startswith("libvalida_vm-")
