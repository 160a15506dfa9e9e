"""The port's BasicMachine (valida_tpu_torch.machine.basic) against the JAX
package's: the fib(25) program of the Rust reference's
`basic/tests/test_prover.rs`, interpreted with its exact profile, proved
on the CPU into the reference's bytes and accepted by both verifiers.

The reference helpers below also make the pins of chip_smoke.py's paths
(n), (h') and (h) and of tests/test_torch_golden.py."""

import hashlib

import numpy as np
import pytest
import torch

from valida_tpu import backend
from valida_tpu.core import config as rconfig
from valida_tpu.core.advice import FixedAdviceProvider as RAdvice
from valida_tpu.core.program import InstructionWord as RIW
from valida_tpu.core.program import Operands as ROperands
from valida_tpu.core.program import ProgramROM as RROM
from valida_tpu.machine import verifier as rverifier
from valida_tpu.machine.basic import BasicMachine as RBasicMachine
from valida_tpu.tooling import serde as rserde
from valida_tpu_torch.core import config
from valida_tpu_torch.core import opcodes as OC
from valida_tpu_torch.machine import examples, verifier
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


# the eight programs of tests/test_golden_programs.py, as (opcode,
# operands) rows, with their static data and the memory cells (offsets from
# fp = 0x1000, or absolute addresses under "abs") that test asserts
GOLDEN = {
    "left_imm_ops": ([
        _iw(OC.IMM32, -4, 0, 0, 0, 3),
        _iw(OC.IMM32, -8, 0, 0, 1, 0),
        _iw(OC.LT32, 4, 3, -4, 1, 0),
        _iw(OC.LTE32, 8, 3, -4, 1, 0),
        _iw(OC.LT32, 12, 4, -4, 1, 0),
        _iw(OC.LTE32, 16, 4, -4, 1, 0),
        _iw(OC.LT32, 20, 2, -4, 1, 0),
        _iw(OC.LTE32, 24, 2, -4, 1, 0),
        _iw(OC.LT32, 28, 256, -4, 1, 0),
        _iw(OC.LTE32, 32, 256, -4, 1, 0),
        _iw(OC.LT32, 36, 3, -8, 1, 0),
        _iw(OC.LTE32, 40, 3, -8, 1, 0),
        _iw(OC.STOP),
    ], None, {4: 0, 8: 1, 12: 0, 16: 0, 20: 1, 24: 1, 28: 0, 32: 0, 36: 1,
              40: 1}),
    "signed_inequality": ([
        _iw(OC.IMM32, -4, 0, 0, 0, 1),
        _iw(OC.IMM32, -8, 255, 255, 255, 255),
        _iw(OC.IMM32, -12, 255, 255, 255, 254),
        _iw(OC.SLT32, 4, -12, -8, 0, 0),
        _iw(OC.SLT32, 8, -12, -4, 0, 0),
        _iw(OC.SLT32, 12, -4, -1, 0, 1),
        _iw(OC.SLT32, 16, -1, -8, 1, 0),
        _iw(OC.SLE32, 20, -1, -8, 1, 0),
        _iw(OC.SLT32, 24, -1, -12, 1, 0),
        _iw(OC.SLT32, 28, -8, -12, 0, 0),
        _iw(OC.SLT32, 32, -8, -4, 0, 0),
        _iw(OC.LT32, 36, -12, -8, 0, 0),
        _iw(OC.LT32, 40, -12, -4, 0, 0),
        _iw(OC.LT32, 44, -4, -1, 0, 1),
        _iw(OC.LT32, 48, -1, -8, 1, 0),
        _iw(OC.LTE32, 52, -1, -8, 1, 0),
        _iw(OC.LT32, 56, -1, -12, 1, 0),
        _iw(OC.LT32, 60, -8, -12, 0, 0),
        _iw(OC.LT32, 64, -8, -4, 0, 0),
        _iw(OC.STOP),
    ], None, {4: 1, 8: 1, 12: 0, 16: 0, 20: 1, 24: 0, 28: 0, 32: 1,
              36: 1, 40: 0, 44: 1, 48: 0, 52: 1, 56: 0, 60: 0, 64: 0}),
    "loadfp": ([
        _iw(OC.LOADFP, 4, 0, 0, 0, 0),
        _iw(OC.LOADFP, 8, 3, 0, 0, 0),
        _iw(OC.STOP),
    ], None, {4: 0x1000, 8: 0x1003}),
    "static_data": ([
        _iw(OC.IMM32, 0, 0, 0, 0, 0x10),
        _iw(OC.LOAD32, -4, 0, 0, 0, 0),
        _iw(OC.BNE, 0, -4, 0x25, 0, 1),
        _iw(OC.STOP),
    ], {0x10: 0x25, 0x14: 0x32}, {-4: 0x25}),
    "storeu8_fresh_address": ([
        _iw(OC.IMM32, -4, 0, 0, 0, 0x41),
        _iw(OC.IMM32, -8, 0, 2, 0, 1),
        _iw(OC.STOREU8, 0, -8, -4, 0, 0),
        _iw(OC.LOADU8, -12, 0, -8, 0, 0),
        _iw(OC.STOP),
    ], None, {"abs": {0x20000: 0x4100}, -12: 0x41}),
    "byte_ops_every_slot": ([
        _iw(OC.IMM32, -4, 0x80, 0x7F, 0xFE, 0x01),
        _iw(OC.IMM32, -8, 0, 0, 0x0F, 0xFC),
        _iw(OC.IMM32, -12, 0, 0, 0x0F, 0xFD),
        _iw(OC.IMM32, -16, 0, 0, 0x0F, 0xFE),
        _iw(OC.IMM32, -20, 0, 0, 0x0F, 0xFF),
        _iw(OC.LOADU8, -24, 0, -8, 0, 0),
        _iw(OC.LOADU8, -28, 0, -12, 0, 0),
        _iw(OC.LOADU8, -32, 0, -16, 0, 0),
        _iw(OC.LOADU8, -36, 0, -20, 0, 0),
        _iw(OC.LOADS8, -40, 0, -12, 0, 0),
        _iw(OC.LOADS8, -44, 0, -16, 0, 0),
        _iw(OC.IMM32, -48, 0, 0, 0, 0xAB),
        _iw(OC.IMM32, -52, 0, 0, 0x20, 0x00),
        _iw(OC.IMM32, -56, 0, 0, 0x20, 0x01),
        _iw(OC.IMM32, -60, 0, 0, 0x20, 0x02),
        _iw(OC.IMM32, -64, 0, 0, 0x20, 0x03),
        _iw(OC.STOREU8, 0, -52, -48, 0, 0),
        _iw(OC.STOREU8, 0, -56, -48, 0, 0),
        _iw(OC.STOREU8, 0, -60, -48, 0, 0),
        _iw(OC.STOREU8, 0, -64, -48, 0, 0),
        _iw(OC.STOP),
    ], None, {-24: 0x01, -28: 0xFE, -32: 0x7F, -36: 0x80, -40: 0xFFFFFFFE,
              -44: 0x7F, "abs": {0x2000: 0xAB00AB00}}),
    "signed_alu": ([
        _iw(OC.IMM32, -4, 0, 0, 0, 100),
        _iw(OC.IMM32, -8, 255, 255, 255, 156),
        _iw(OC.IMM32, -12, 0, 0, 0, 7),
        _iw(OC.IMM32, -16, 255, 255, 255, 249),
        _iw(OC.SDIV32, -20, -8, -12, 0, 0),
        _iw(OC.SDIV32, -24, -8, -16, 0, 0),
        _iw(OC.SDIV32, -28, -4, -16, 0, 0),
        _iw(OC.SDIV32, -32, -4, -12, 0, 0),
        _iw(OC.IMM32, -36, 128, 0, 0, 0),
        _iw(OC.IMM32, -40, 255, 255, 255, 255),
        _iw(OC.SDIV32, -44, -36, -40, 0, 0),
        _iw(OC.SRA32, -48, -8, 1, 0, 1),
        _iw(OC.IMM32, -52, 255, 255, 255, 251),
        _iw(OC.SRA32, -56, -52, 1, 0, 1),
        _iw(OC.SRA32, -60, -52, 31, 0, 1),
        _iw(OC.MULHS32, -64, -8, -12, 0, 0),
        _iw(OC.MULHS32, -68, -8, -16, 0, 0),
        _iw(OC.IMM32, -72, 222, 173, 190, 239),
        _iw(OC.MULHU32, -76, -72, -72, 0, 0),
        _iw(OC.MULHS32, -80, -72, -72, 0, 0),
        _iw(OC.MULHU32, -84, -8, -12, 0, 0),
        _iw(OC.STOP),
    ], None, {-20: 4294967282, -24: 14, -28: 4294967282, -32: 14,
              -44: 0x80000000, -48: 4294967246, -56: 4294967293,
              -60: 4294967295, -64: 4294967295, -68: 0,
              -76: 0xC1B1CD12, -80: 0x04564F34, -84: 6}),
    "alu_mix": ([
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
        _iw(OC.SRA32, -56, -4, 4, 0, 1),
        _iw(OC.STOP),
    ], None, {-12: 700, -16: 100, -20: 28, -24: 12, -28: 4, -32: 103,
              -36: 99, -40: 0, -44: 1, -48: 93, -52: 0, -56: 6}),
}


def program(name):
    """(instruction rows, fp, static data) of a named program: the eight of
    GOLDEN, "fib" (fib(25)) and "alu_loop_<log_cycles>" (the ALU loop that
    fills 2^log_cycles rows, fp = 0x1000000 as benchmarks/big_trace.py)."""
    if name in GOLDEN:
        rows, static, _cells = GOLDEN[name]
        return rows, 0x1000, static
    if name == "fib":
        prog = examples.fib_program()
        fp = 0x1000
    else:
        log_cycles = int(name.removeprefix("alu_loop_"))
        prog = examples.alu_loop_program((1 << log_cycles) // 14)
        fp = 0x1000000
    return [(iw.opcode, iw.operands.ops) for iw in prog], fp, None


def port_machine(name):
    rows, fp, static = program(name)
    return examples.run_program(
        [examples.instruction(op, *ops) for op, ops in rows], fp, static)


def reference_machine(name):
    """The JAX package's BasicMachine after running the named program."""
    rows, fp, static = program(name)
    m = RBasicMachine()
    m.program().set_program_rom(RROM([RIW(op, ROperands(ops))
                                      for op, ops in rows]))
    for addr, value in (static or {}).items():
        m.static_data().write(addr, value)
    m.cpu().fp = fp
    m.cpu().registers.append((m.cpu().pc, m.cpu().fp))
    m.run(advice=RAdvice.empty())
    return m


def _reference_config(name):
    return {"test": rconfig.test_config, "default": rconfig.default_config}[
        name]()


def reference_basic_digest(name, config_name="test") -> str:
    """SHA-256 of the serialized proof of the named program under
    test_config() or default_config(), as the JAX package's numpy path
    makes it (tests/test_torch_golden.py's constants; chip_smoke.py's (n)
    "fib" and (h') "alu_loop_13" under "default": about 10 s and 1
    minute)."""
    m = reference_machine(name)
    with backend.use_backend("numpy"):
        proof = m.prove(_reference_config(config_name))
    return hashlib.sha256(rserde.serialize_proof(proof)).hexdigest()


def reference_basic_roots(log_cycles: int) -> list:
    """The preprocessed and main-trace commitment roots (hex of the
    little-endian words) of the ALU loop at 2^log_cycles rows under
    default_config(), as the JAX package's numpy PCS commits them; no
    challenge is needed for either (chip_smoke.py's path (h), log_cycles
    20: several minutes)."""
    m = reference_machine(f"alu_loop_{log_cycles}")
    pcs = rconfig.default_config().pcs
    chips = m.chips()
    prep = [np.asarray(c.preprocessed_trace(), dtype=np.uint32)
            for c in chips if c.preprocessed_trace() is not None]
    main = [np.asarray(c.generate_trace(m), dtype=np.uint32) for c in chips]
    with backend.use_backend("numpy"):
        return [np.asarray(pcs.commit_batches(mats)[0], dtype="<u4")
                .tobytes().hex() for mats in (prep, main)]


# ---------------------------------------------------------------------------
# fib(25)
# ---------------------------------------------------------------------------


def test_programs_are_the_reference_programs():
    """The port's fib(25) and ALU loop are, word for word, the programs of
    the JAX package's tests/test_basic_machine.py and
    benchmarks/big_trace.py."""
    from benchmarks.big_trace import alu_loop_program
    from tests.test_basic_machine import fib_program

    def words(prog):
        return [(iw.opcode, tuple(iw.operands.ops)) for iw in prog]

    assert words(examples.fib_program()) == words(fib_program())
    n_iters = (1 << 13) // 14
    assert words(examples.alu_loop_program(n_iters)) == \
        words(alu_loop_program(n_iters))


def test_fib_interpreter_profile():
    """`basic/tests/test_prover.rs:473-487`: clock 192, 401 memory
    operations, 105 adds, fib(25) = 75025 at fp + 4."""
    m = port_machine("fib")
    assert m.cpu().clock == 192
    assert len(m.cpu().operations) == 192
    assert sum(len(v) for v in m.mem().operations.values()) == 401
    assert len(m.add_u32().operations) == 105
    assert m.mem().cells[0x1000 + 4] == 75025


@pytest.fixture(scope="module")
def fib_proofs():
    """(ref machine, port machine, ref proof, port proof) of fib(25) under
    test_config(), the reference's proof made live."""
    ref_m = reference_machine("fib")
    with backend.use_backend("numpy"):
        ref_proof = ref_m.prove(rconfig.test_config())
    m = port_machine("fib")
    return ref_m, m, ref_proof, m.prove(config.test_config(device="cpu"))


def test_fib_proof_bytes_match_reference(fib_proofs):
    _ref_m, _m, ref_proof, proof = fib_proofs
    blob = serde.serialize_proof(proof)
    assert blob == rserde.serialize_proof(ref_proof)
    assert len(blob) < 70_000


def test_fib_cross_verification(fib_proofs):
    """Each package's verifier accepts the other's proof, carried across
    as bytes."""
    ref_m, m, ref_proof, proof = fib_proofs
    with backend.use_backend("numpy"):
        ref_m.verify(rconfig.test_config(),
                     rserde.deserialize_proof(serde.serialize_proof(proof)))
    m.verify(config.test_config(device="cpu"),
             serde.deserialize_proof(rserde.serialize_proof(ref_proof)))


@pytest.mark.parametrize("case", ["opened trace value", "cumulative sum"])
def test_fib_tamper_same_error(fib_proofs, case):
    """chip_smoke.py's tampers of path (h) on fib(25): both packages raise
    the VerificationError subclass chip_smoke.py expects."""
    import chip_smoke

    tamper, expected = chip_smoke.TAMPERS[case]
    ref_m, m, ref_proof, proof = fib_proofs
    with backend.use_backend("numpy"):
        with pytest.raises(rverifier.VerificationError) as want:
            ref_m.verify(rconfig.test_config(), tamper(ref_proof))
    with pytest.raises(verifier.VerificationError) as got:
        m.verify(config.test_config(device="cpu"), tamper(proof))
    assert type(got.value).__name__ == type(want.value).__name__ == expected


def test_basic_machine_needs_a_gpu_by_default():
    """The default config is the card's: without a GPU, proving the
    BasicMachine raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    m = port_machine("fib")
    with pytest.raises(RuntimeError, match="cuda"):
        m.prove(config.default_config())


def test_bus_report_matches_reference():
    """The bus-traffic report reads the chips' traces through the builders:
    on fib(25) with one add row lost it names the same messages and rows as
    the JAX package's."""
    from valida_tpu.air.bus_debug import report_imbalances as ref_report
    from valida_tpu_torch.air.bus_debug import report_imbalances

    ref_m, m = reference_machine("fib"), port_machine("fib")
    assert report_imbalances(m) == ref_report(ref_m)
    assert "IMBALANCED" not in report_imbalances(m)
    ref_m.add_u32().operations.pop()
    m.add_u32().operations.pop()
    assert report_imbalances(m) == ref_report(ref_m)
    assert "IMBALANCED" in report_imbalances(m)
