"""The benchmark's SHA-256 chain guest (proverbench/programs/sha2_chain.json:
a16z zkvm-benchmarks' sha2-chain, h <- SHA-256(h)) on the CPU at the
configuration's 2^13-cycle size, two steps a job, built from its seeds as
the benchmark builds a job (`spec.job_program`): the port's execution
(`run_native(build_lists=False)`) equals the benchmark's plain
interpreter, its digest equals `hashlib.sha256` iterated, every seed gives
the same chip heights, and one `prove_jit` under the configuration's proof
profile is accepted by the port's verifier and by the benchmark's judge;
executed in list mode, the job gives the same range counts, memory rows
and proof bytes.  About 35 s, most of it the two proves."""

import hashlib
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "proverbench"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

import port  # noqa: E402  (proverbench/: the benchmark's driver of the port)
import spec  # noqa: E402
from reference import interp, verify  # noqa: E402

CONFIG = "sha2_chain"
LOG_CYCLES = 13
SEEDS = (2**33 + 11, 2**31 + 5, 3_200_000_017)


@pytest.fixture(scope="module")
def cell():
    config = spec.load_json(spec.ROOT / spec.config_entry(
        spec.benchmark(), CONFIG)["file"])
    program = spec.load_json(spec.HERE / "programs"
                             / f"{config['program']}.json")
    port.build("cpu")
    return spec.Cell(f"{CONFIG}.test", 1, config,
                     {"log_cycles": LOG_CYCLES}, program,
                     config["sizes"][str(LOG_CYCLES)])


def _job(c, seed):
    """(instructions, the port's machine after execution)."""
    instructions = spec.job_program(c, seed, 0)
    return instructions, port.execute(instructions, int(c.program["fp"]))


def _heights(m) -> dict:
    """{chip: log height} of an executed machine's main traces, as the
    prover sizes them."""
    out = {}
    for chip in m.chips():
        dti = chip.device_trace_inputs(m)
        h = (int(dti[1][1]) if dti is not None
             else int(chip.generate_trace(m).shape[0]))
        out[chip.name] = h.bit_length() - 1
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_execution_equals_the_reference(cell, seed):
    """The port's final memory and cycle count are the plain
    interpreter's, and the cycles are the size's frozen count."""
    instructions, m = _job(cell, seed)
    memory, cycles = port.outcome(m)
    assert (memory, cycles) == interp.run(instructions,
                                          int(cell.program["fp"]))
    assert cycles == cell.size["cycles"] == (
        cell.program["fixed_cycles"]
        + cell.program["cycles_per_iter"] * cell.size["loop_count"])


@pytest.mark.parametrize("seed", SEEDS)
def test_digest_is_the_hashlib_chain(cell, seed):
    """The words at the program's digest offsets are SHA-256 applied
    loop_count times to the job's eight start words (big-endian)."""
    _instructions, m = _job(cell, seed)
    memory, _cycles = port.outcome(m)
    fp = int(cell.program["fp"])
    got = [memory[(fp + off) & 0xFFFFFFFF] for off in cell.program["digest"]]
    inputs = spec.job_inputs(cell, seed, 0)
    value = struct.pack(">8I", *(inputs[f"h{i}"] for i in range(8)))
    for _ in range(cell.size["loop_count"]):
        value = hashlib.sha256(value).digest()
    assert got == list(struct.unpack(">8I", value))


def test_seeds_give_the_frozen_heights(cell):
    """Two seeds' jobs have the same chip heights, the configuration's
    frozen ones: the guest runs the same instructions whatever the data."""
    want = {k: v["log_height"] for k, v in cell.size["chips"].items()}
    got = [_heights(_job(cell, seed)[1]) for seed in SEEDS[:2]]
    assert got[0] == got[1] == want
    assert want["bitwise_u32"] >= 12 and want["shift_u32"] >= 12


def _list_mode(instructions, fp):
    """port.execute's machine with the op logs as Python lists and dicts
    (`run_native(build_lists=True)`): the memory rows sorted and their
    delta limbs counted by the numpy version, not native/memsort.cpp."""
    from valida_tpu_torch.core import opcodes as OC
    from valida_tpu_torch.core.program import (InstructionWord, Operands,
                                               ProgramROM)
    from valida_tpu_torch.machine.basic import BasicMachine

    m = BasicMachine()
    m.program().set_program_rom(ProgramROM([
        InstructionWord(getattr(OC, op), Operands(tuple(ops)))
        for op, ops in instructions]))
    m.cpu().fp = fp
    m.run_native(build_lists=True)
    return m


@pytest.fixture(scope="module")
def proved(cell):
    """{"arrays": machine, "lists": machine, "cfg": config, "instructions":
    the job's program, "bytes": {mode: the proof's bytes}} for one job
    (SEEDS[2]) executed in array mode (as the benchmark does) and in list
    mode, each proved by `prove_jit` under the configuration's profile and
    the array mode's proof verified by the port."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        instructions, arrays = _job(cell, SEEDS[2])
        lists = _list_mode(instructions, int(cell.program["fp"]))
        cfg = port.prover_config(cell.config["profile"], "cpu")
        out = {"arrays": arrays, "lists": lists, "cfg": cfg,
               "instructions": instructions, "bytes": {}}
        for mode in ("arrays", "lists"):
            proof = port.prove(out[mode], cfg)
            if mode == "arrays":
                out[mode].verify(cfg, proof)
                out["heights"] = {
                    chip.name: int(cp.log_degree)
                    for chip, cp in zip(arrays.chips(), proof.chip_proofs)}
            out["bytes"][mode] = port.serialize(proof, cfg)
    finally:
        torch.set_num_threads(threads)
    return out


def test_prove_accepted_by_the_port_and_the_judge(cell, proved):
    """One job's `prove_jit` under the configuration's profile: the
    port's verifier accepts it, the benchmark's judge accepts its bytes,
    and its chip heights are the frozen ones."""
    assert verify.judge(proved["bytes"]["arrays"], proved["instructions"],
                        int(cell.program["fp"]),
                        cell.config["profile"]) is None
    assert proved["heights"] == {k: v["log_height"]
                                 for k, v in cell.size["chips"].items()}


def test_list_mode_gives_the_same_range_counts_rows_and_proof(proved):
    """The job in list mode (memory rows sorted and counted in numpy)
    against array mode (in native/memsort.cpp): the same range chip
    counts, the same memory trace inputs word for word and the same proof
    bytes."""
    arrays, lists = proved["arrays"], proved["lists"]
    assert arrays.mem().ops_arrays is not None
    assert lists.mem().ops_arrays is None
    assert arrays.range().count == lists.range().count
    got, got_meta = arrays.mem().device_trace_inputs(arrays)
    want, want_meta = lists.mem().device_trace_inputs(lists)
    assert got_meta == want_meta
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    assert proved["bytes"]["lists"] == proved["bytes"]["arrays"]
