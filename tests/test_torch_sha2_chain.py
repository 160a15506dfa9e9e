"""The benchmark's SHA-256 chain guest (proverbench/programs/sha2_chain.json:
a16z zkvm-benchmarks' sha2-chain, h <- SHA-256(h)) on the CPU at the
configuration's 2^13-cycle size, two steps a job, built from its seeds as
the benchmark builds a job (`spec.job_program`): the port's execution
(`run_native(build_lists=False)`) equals the benchmark's plain
interpreter, its digest equals `hashlib.sha256` iterated, every seed gives
the same chip heights, and one `prove_jit` under the configuration's proof
profile is accepted by the port's verifier and by the benchmark's judge.
About 25 s, most of it the prove."""

import hashlib
import struct
import sys
from pathlib import Path

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


def test_prove_accepted_by_the_port_and_the_judge(cell):
    """One job's `prove_jit` under the configuration's profile: the
    port's verifier accepts it, the benchmark's judge accepts its bytes,
    and its chip heights are the frozen ones."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        instructions, m = _job(cell, SEEDS[2])
        profile = cell.config["profile"]
        cfg = port.prover_config(profile, "cpu")
        proof = port.prove(m, cfg)
        m.verify(cfg, proof)
        data = port.serialize(proof, cfg)
    finally:
        torch.set_num_threads(threads)
    assert verify.judge(data, instructions, int(cell.program["fp"]),
                        profile) is None
    heights = {chip.name: int(cp.log_degree)
               for chip, cp in zip(m.chips(), proof.chip_proofs)}
    assert heights == {k: v["log_height"]
                       for k, v in cell.size["chips"].items()}
