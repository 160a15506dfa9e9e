"""The port's BasicMachine chips (valida_tpu_torch.chips) against the JAX
package's: every chip's trace, built by the port on the CPU, equals the
reference's `generate_trace` word for word, on three machines: the random
op mix of tests/test_device_tracegen.py (200 operations a chip, written
into both packages' chips), the byte-op/jump/output program of the same
file, and the ALU loop at 2^13 cycles (each package interpreting it).
Also the verifier's host Keccak (numpy uint64 lanes) against the plain
version, the JAX package's and known answers."""

import copy

import numpy as np
import pytest
import torch

from tests.test_device_tracegen import _loaded_machine, _program_machine
from tests.test_torch_basic import port_machine, reference_machine
from valida_tpu.crypto import keccak as rkeccak
from valida_tpu_torch.chips.chip import trace_on
from valida_tpu_torch.convert import to_numpy
from valida_tpu_torch.core.advice import FixedAdviceProvider
from valida_tpu_torch.core.program import ProgramROM
from valida_tpu_torch.crypto import keccak
from valida_tpu_torch.machine.basic import BasicMachine

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's CPU
    operations on one thread each keep them from crowding the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CHIPS = ["cpu", "program", "mem", "add_u32", "sub_u32", "mul_u32", "div_u32",
         "shift_u32", "lt_u32", "com_u32", "bitwise_u32", "output", "range",
         "static_data", "byte"]
# made on the host and uploaded once; every other chip has a builder
HOST_BUILT = {"program", "range", "static_data", "output"}
_LOGS = ("operations", "registers", "clock", "pc", "fp", "cells",
         "static_data", "values", "count", "counts")


def _port_copy(ref_m):
    """A port BasicMachine holding the reference machine's op logs."""
    m = BasicMachine()
    for rc, pc in zip(ref_m.chips(), m.chips()):
        assert rc.name == pc.name
        for attr in _LOGS:
            if hasattr(rc, attr) and not callable(getattr(rc, attr)):
                setattr(pc, attr, copy.deepcopy(getattr(rc, attr)))
    return m


def _program_pair():
    ref_m = _program_machine()
    m = BasicMachine()
    m.program().set_program_rom(ProgramROM.from_machine_code(
        ref_m.program().program_rom.to_machine_code()))
    m.cpu().fp = 0x2000
    m.cpu().registers.append((m.cpu().pc, m.cpu().fp))
    m.run(advice=FixedAdviceProvider.empty())
    return ref_m, m


@pytest.fixture(scope="module")
def machines():
    ref_ops = _loaded_machine()
    return {
        "ops": (ref_ops, _port_copy(ref_ops)),
        "program": _program_pair(),
        "alu_loop_13": (reference_machine("alu_loop_13"),
                        port_machine("alu_loop_13")),
    }


# the op mix has no program, so no program chip
CASES = [(inputs, chip) for inputs in ("ops", "program", "alu_loop_13")
         for chip in CHIPS if (inputs, chip) != ("ops", "program")]


@pytest.mark.parametrize("inputs, chip_name", CASES)
def test_trace_matches_reference(machines, inputs, chip_name):
    ref_m, m = machines[inputs]
    rc = next(c for c in ref_m.chips() if c.name == chip_name)
    pc = next(c for c in m.chips() if c.name == chip_name)
    has_builder = pc.device_trace_inputs(m) is not None
    assert has_builder == (chip_name not in HOST_BUILT)
    want = np.asarray(rc.generate_trace(ref_m), dtype=np.uint32)
    got = to_numpy(trace_on(pc, m, "cpu"))
    np.testing.assert_array_equal(got, want, err_msg=chip_name)
    if rc.preprocessed_trace() is not None:
        np.testing.assert_array_equal(pc.preprocessed_trace(),
                                      rc.preprocessed_trace())


def test_interpreters_agree():
    """The ALU loop leaves the same clock, registers, memory and op logs
    in both packages' interpreters."""
    ref_m, m = reference_machine("alu_loop_10"), port_machine("alu_loop_10")
    assert m.cpu().clock == ref_m.cpu().clock == 73 * 13 + 4
    assert (m.cpu().pc, m.cpu().fp) == (ref_m.cpu().pc, ref_m.cpu().fp)
    assert m.mem().cells == ref_m.mem().cells
    assert m.mem().operations == ref_m.mem().operations
    for rc, pc in zip(ref_m.chips(), m.chips()):
        if hasattr(rc, "operations"):
            assert pc.operations == rc.operations, rc.name


@pytest.mark.parametrize("n_words", [0, 1, 7, 8, 16, 17, 33, 34, 35, 51, 68,
                                     69, 128])
def test_host_keccak_matches_plain_and_reference(n_words):
    rng = np.random.default_rng(n_words)
    words = rng.integers(0, 1 << 32, size=(5, n_words), dtype=np.uint64) \
        .astype(np.uint32)
    got = keccak.keccak256_words_numpy(words)
    plain = to_numpy(keccak.keccak256_words_plain(
        torch.from_numpy(words.view(np.int32))))
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, rkeccak.keccak256_words(words))


def test_host_keccak_permutation_matches_reference():
    """The host version's uint64 lanes against the reference's (lo, hi)
    u32 halves."""
    rng = np.random.default_rng(5)
    lo, hi = (rng.integers(0, 1 << 32, size=(16, 25), dtype=np.uint64)
              .astype(np.uint32) for _ in range(2))
    want_lo, want_hi = rkeccak.keccak_f(lo.copy(), hi.copy())
    lanes = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    got = keccak.keccak_f_numpy(lanes.T.copy()).T
    np.testing.assert_array_equal(
        (got & np.uint64(0xFFFFFFFF)).astype(np.uint32), want_lo)
    np.testing.assert_array_equal(
        (got >> np.uint64(32)).astype(np.uint32), want_hi)


def test_host_keccak_known_answers():
    """tests/test_crypto.py's vectors: Keccak-256 of the empty message and
    of one zero word."""
    for words, want in (
        ([], "c5d2460186f7233c927e7db2dcc703c0"
             "e500b653ca82273b7bfad8045d85a470"),
        ([0], "e8e77626586f73b955364c7b4bbf0bb7"
              "f7685ebd40e852b164633a4acbd3244c"),
    ):
        got = keccak.keccak256_words_numpy(
            np.array([words], dtype=np.uint32).reshape(1, len(words)))
        assert got[0].astype("<u4").tobytes().hex() == want
