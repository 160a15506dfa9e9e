"""The port's machine compositions (valida_tpu_torch.machine.compositions)
against the JAX package's: `ExtendedMachine` (BasicMachine + the native
field chip, FADD/FSUB/FMUL) and `LoadStoreMachine` (no ALU chips), on the
programs of tests/test_compositions.py, interpreted by `run` and by both
modes of `run_native`, traced and proved on the CPU into the JAX
package's bytes.

`reference_composition_digest` makes chip_smoke.py's pins of paths (x)
and (l)."""

import hashlib

import numpy as np
import pytest
import torch

from tests.test_compositions import LS_ASM, NF_ASM
from valida_tpu import backend
from valida_tpu.core import config as rconfig
from valida_tpu.core.advice import FixedAdviceProvider as RAdvice
from valida_tpu.core.program import ProgramROM as RROM
from valida_tpu.machine import compositions as rcompositions
from valida_tpu.tooling import serde as rserde
from valida_tpu.tooling.assembler import assemble as rassemble
from valida_tpu_torch.chips.chip import trace_on
from valida_tpu_torch.convert import to_numpy
from valida_tpu_torch.core import config
from valida_tpu_torch.core.advice import FixedAdviceProvider
from valida_tpu_torch.core.program import ProgramROM
from valida_tpu_torch.field import babybear as bb
from valida_tpu_torch.machine import compositions
from valida_tpu_torch.native import NativeRunError
from valida_tpu_torch.tooling import serde
from valida_tpu_torch.tooling.assembler import assemble


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's CPU
    operations on one thread each keep them from crowding the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# chip_smoke.py's paths: (machine class name, assembly)
PROGRAMS = {"x": ("ExtendedMachine", NF_ASM),
            "l": ("LoadStoreMachine", LS_ASM)}


def reference_machine(path):
    """The JAX package's composed machine after `run` of the path's
    program (fp 0x1000, as tests/test_compositions.py)."""
    cls, asm = PROGRAMS[path]
    m = getattr(rcompositions, cls)()
    m.program().set_program_rom(RROM.from_machine_code(rassemble(asm)))
    m.cpu().fp = 0x1000
    m.cpu().registers.append((m.cpu().pc, m.cpu().fp))
    m.run(advice=RAdvice.empty())
    return m


def port_machine(path, interpreter):
    """The port's composed machine after `interpreter` ("run", "lists" for
    run_native(build_lists=True) or "arrays" for build_lists=False)."""
    cls, asm = PROGRAMS[path]
    m = getattr(compositions, cls)()
    m.program().set_program_rom(ProgramROM.from_machine_code(assemble(asm)))
    m.cpu().fp = 0x1000
    m.cpu().registers.append((m.cpu().pc, m.cpu().fp))
    if interpreter == "run":
        m.run(advice=FixedAdviceProvider.empty())
    else:
        m.run_native(build_lists=interpreter == "lists")
    return m


def reference_composition_digest(path, config_name="default") -> str:
    """SHA-256 of the serialized proof of path (x) or (l) under
    default_config() (or test_config()), as the JAX package's numpy path
    makes it (chip_smoke.py's COMPOSITION_GOLDEN; seconds)."""
    m = reference_machine(path)
    cfg = {"test": rconfig.test_config,
           "default": rconfig.default_config}[config_name]()
    with backend.use_backend("numpy"):
        proof = m.prove(cfg)
    return hashlib.sha256(rserde.serialize_proof(proof)).hexdigest()


def test_chip_smoke_programs_are_the_reference_tests():
    import chip_smoke

    assert chip_smoke.COMPOSITION_PATHS["x"][:2] == PROGRAMS["x"]
    assert chip_smoke.COMPOSITION_PATHS["l"][:2] == PROGRAMS["l"]


@pytest.mark.parametrize("interpreter", ["run", "lists", "arrays"])
def test_extended_machine_native_field_ops(interpreter):
    """FADD, FMUL, FSUB of 1,000,000 give the field results, in the field
    chip's log and in memory."""
    from valida_tpu_torch.chips.alu import _ops_to_arrays
    from valida_tpu_torch.chips.native_field import KINDS

    m = port_machine("x", interpreter)
    a = 1000000
    add = (a + a) % bb.P
    mul = add * a % bb.P
    sub = (a - add) % bb.P
    kinds, out, _b, _c = _ops_to_arrays(m.native_field().operations, KINDS)
    assert [(KINDS[k], x) for k, x in zip(kinds.tolist(), out.tolist())] \
        == [("add", add), ("mul", mul), ("sub", sub)]
    fp = m.cpu().fp
    assert [m.mem().peek((fp - off) & 0xFFFFFFFF) for off in (12, 16, 20)] \
        == [add, mul, sub]


CHIPS = {
    "x": ["cpu", "program", "mem", "add_u32", "sub_u32", "mul_u32",
          "div_u32", "shift_u32", "lt_u32", "com_u32", "bitwise_u32",
          "output", "range", "static_data", "byte", "native_field"],
    "l": ["cpu", "program", "mem", "output", "range", "static_data", "byte"],
}


@pytest.fixture(scope="module")
def machines():
    return {(path, interp): port_machine(path, interp)
            for path in PROGRAMS for interp in ("run", "lists", "arrays")}


@pytest.fixture(scope="module")
def references():
    return {path: reference_machine(path) for path in PROGRAMS}


@pytest.mark.parametrize("path, interpreter, chip_name", [
    (path, interp, chip) for path in PROGRAMS
    for interp in ("run", "lists", "arrays") for chip in CHIPS[path]])
def test_trace_matches_reference(machines, references, path, interpreter,
                                 chip_name):
    """Every chip's trace, after `run` or either mode of `run_native`,
    equals the JAX package's `generate_trace` after its `run` (the JAX
    package's own field chip takes list-mode logs only)."""
    m, ref = machines[(path, interpreter)], references[path]
    assert [c.name for c in m.chips()] == [c.name for c in ref.chips()] \
        == CHIPS[path]
    rc = next(c for c in ref.chips() if c.name == chip_name)
    pc = next(c for c in m.chips() if c.name == chip_name)
    want = np.asarray(rc.generate_trace(ref), dtype=np.uint32)
    np.testing.assert_array_equal(to_numpy(trace_on(pc, m, "cpu")), want,
                                  err_msg=chip_name)


@pytest.mark.parametrize("path", list(PROGRAMS))
def test_proof_bytes_match_reference(machines, references, path):
    """Proved from array mode under test_config() on the CPU, each
    composition's proof serializes to the JAX package's numpy-path bytes,
    and the port's verifier accepts it."""
    m = machines[(path, "arrays")]
    cfg = config.test_config(device="cpu")
    proof = m.prove(cfg)
    with backend.use_backend("numpy"):
        ref_proof = references[path].prove(rconfig.test_config())
    assert serde.serialize_proof(proof) == rserde.serialize_proof(ref_proof)
    m.verify(cfg, proof)


def test_loadstore_machine_output():
    assert port_machine("l", "arrays").output().bytes() == bytes([77])


@pytest.mark.parametrize("interpreter", ["run", "lists", "arrays"])
def test_loadstore_machine_rejects_alu_opcodes(interpreter):
    m = compositions.LoadStoreMachine()
    code = assemble("main:\n    add -4(fp), -8(fp), -12(fp)\n    stop\n")
    m.program().set_program_rom(ProgramROM.from_machine_code(code))
    m.cpu().fp = 0x1000
    with pytest.raises(RuntimeError, match="Unrecognized opcode: 100") as e:
        if interpreter == "run":
            m.run(advice=FixedAdviceProvider.empty())
        else:
            m.run_native(build_lists=interpreter == "lists")
    assert (interpreter == "run") != isinstance(e.value, NativeRunError)
