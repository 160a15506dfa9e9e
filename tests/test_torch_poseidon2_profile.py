"""The benchmark's Poseidon2 configuration (proverbench/configs/
fibonacci_poseidon2.json: SP1's core-shard FRI profile, Poseidon2-16
Merkle trees and 100 queries, on Valida's fib guest) on the CPU.

The judge's frozen Poseidon2 (proverbench/reference/frozen/crypto/
poseidon2.py, canonical words in numpy) hashes as the JAX package's numpy
Poseidon2 and the port's plain version do.  One job at the
configuration's 2^10-cycle size, built from its seed as the benchmark
builds a job (`spec.job_program`), is executed by the C++ core and proved
by `prove_jit` under the configuration's profile with one number lowered:
8 proof-of-work bits for 16, since the grind's plain version on the CPU
takes about 9 s at 16 bits (a grind costs twice as much a bit; the card
grinds the configuration's 16).  The judge accepts the proof's bytes
under that profile and rejects them with one opened digest or the grind's
witness altered; the plain interpreter gives the job's memory and cycles.
The Poseidon2 count of `proverbench/trees.py` equals the permutations the
port's plain Poseidon2 runs, in `merkle_levels` at a mixed-height shape
and in the whole prove.  About 15 s, most of it the prove's plain
Poseidon2 trees."""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from valida_tpu.crypto import poseidon2 as jax_p2
from valida_tpu_torch.crypto import merkle
from valida_tpu_torch.crypto import poseidon2 as p2
from valida_tpu_torch.tooling import serde

BENCH = Path(__file__).resolve().parents[1] / "proverbench"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

import port  # noqa: E402  (proverbench/: how the benchmark calls the port)
import spec  # noqa: E402
import trees  # noqa: E402
from reference import interp, verify  # noqa: E402
from reference.frozen.crypto import poseidon2 as frozen_p2  # noqa: E402

CONFIG = "fibonacci_poseidon2"
LOG_CYCLES = 10
SEED = 2**33 + 24
TEST_POW_BITS = 8  # the configuration's 16, lowered (module docstring)


@pytest.mark.parametrize("seed", (1, 2**31 + 9, 77_000_001))
@pytest.mark.parametrize("width", (1, 7, 8, 9, 16, 51))
def test_frozen_poseidon2_hashes_as_the_port_and_the_jax_package(width,
                                                                 seed):
    """Rows of any u32 words, of widths around the rate (8) and the trees'
    (16 for a compression, 51 for a cpu row): the frozen hash, batched and
    one message at a time, equals the port's plain version and the JAX
    package's numpy Poseidon2."""
    words = np.random.default_rng([seed, width]).integers(
        0, 2**32, size=(17, width), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jax_p2.hash_words(words), dtype=np.uint32)
    port_plain = p2.hash_words_plain(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(port_plain.numpy().view(np.uint32), want)
    got = frozen_p2.hash_words(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (17, 8)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(frozen_p2.hash_words_host(words[3]),
                                  want[3])


def _counted_permute(monkeypatch) -> list:
    """Count the states the port's plain Poseidon2 permutes."""
    rows = []
    permute = p2.permute

    def counted(state):
        rows.append(int(state.shape[0]))
        return permute(state)

    monkeypatch.setattr(p2, "permute", counted)
    return rows


def test_tree_count_equals_the_permutations_merkle_levels_runs(monkeypatch):
    """trees.tree_permutations' Poseidon2 count of a mixed-height tree
    (leaves of 51 words, matrices injected at two lower levels, one of
    them of two matrices) equals the permutations the port's
    `merkle_levels` runs on the CPU; its Keccak count is roofline.py's."""
    import roofline

    shapes = [(6, 51), (6, 16), (4, 15), (2, 1), (2, 7)]
    rng = np.random.default_rng(5)
    mats = [torch.from_numpy(rng.integers(0, 2**31 - 2**27, size=(1 << lh, w),
                                          dtype=np.int64).astype(np.int32))
            for lh, w in shapes]
    rows = _counted_permute(monkeypatch)
    merkle.merkle_levels(mats, "poseidon2")
    assert sum(rows) == trees.tree_permutations(shapes, "poseidon2") > 0
    assert (trees.tree_permutations(shapes, "keccak")
            == roofline.tree_permutations(shapes))


@pytest.fixture(scope="module")
def proved():
    """One job of the configuration at 2^10 cycles, executed and proved
    under the lowered profile, with the permutations of every Poseidon2
    call the prove made: {"cell", "profile", "instructions", "machine",
    "proof", "bytes", "permuted"}."""
    bench = spec.benchmark()
    config = spec.load_json(spec.ROOT / spec.config_entry(bench, CONFIG)
                            ["file"])
    program = spec.load_json(spec.HERE / "programs"
                             / f"{config['program']}.json")
    c = spec.Cell(f"{CONFIG}.test", 1, config, {"log_cycles": LOG_CYCLES},
                  program, config["sizes"][str(LOG_CYCLES)])
    profile = dict(config["profile"], proof_of_work_bits=TEST_POW_BITS)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        port.build("cpu")
        cfg = port.prover_config(profile, "cpu")
        instructions = spec.job_program(c, SEED, 0)
        m = port.execute(instructions, int(program["fp"]))
        with pytest.MonkeyPatch.context() as mp:
            rows = _counted_permute(mp)
            proof = port.prove(m, cfg)
        data = port.serialize(proof, cfg)
    finally:
        torch.set_num_threads(threads)
    return {"cell": c, "profile": profile, "instructions": instructions,
            "machine": m, "proof": proof, "bytes": data,
            "permuted": sum(rows)}


def _judge(proved, data):
    return verify.judge(data, proved["instructions"],
                        int(proved["cell"].program["fp"]), proved["profile"])


def test_profile_is_sp1s_core_profile(proved):
    """The configuration states SP1's core-shard FRI profile, and the
    proof carries 100 queries and the Poseidon2 digests' heights."""
    c = proved["cell"]
    assert c.config["profile"] == {
        "num_queries": 100, "proof_of_work_bits": 16, "log_blowup": 1,
        "hasher": "poseidon2", "debug_checks": False}
    assert len(proved["proof"].opening_proof.query_proofs) == 100
    assert {chip.name: cp.log_degree for chip, cp in zip(
        proved["machine"].chips(), proved["proof"].chip_proofs)} == {
        k: v["log_height"] for k, v in c.size["chips"].items()}


def test_job_executes_as_the_reference_and_the_judge_accepts(proved):
    """The plain interpreter gives the job's final memory and cycles (the
    size's frozen count), and the judge accepts the proof's bytes."""
    c = proved["cell"]
    want = interp.run(proved["instructions"], int(c.program["fp"]))
    assert port.outcome(proved["machine"]) == want
    assert want[1] == c.size["cycles"]
    assert _judge(proved, proved["bytes"]) is None


def _tampered(proved, alter) -> bytes:
    proof = copy.deepcopy(proved["proof"])
    alter(proof)
    return serde.serialize_proof(proof)


def _flip_path_digest(proof):
    """One word of one opened sibling digest of the main trace's tree."""
    opening = proof.opening_proof.query_proofs[7].input_openings[1]
    opening.path[2] = opening.path[2].copy()
    opening.path[2][5] ^= 1


def _bump_witness(proof):
    proof.opening_proof.fri.pow_witness += 1


@pytest.mark.parametrize("alter", (_flip_path_digest, _bump_witness),
                         ids=("opened digest", "grind witness"))
def test_judge_rejects_an_altered_proof(proved, alter):
    """One opened digest or the grind's witness altered: the bytes differ
    and the judge names why it rejects them."""
    data = _tampered(proved, alter)
    assert data != proved["bytes"]
    why = _judge(proved, data)
    assert isinstance(why, str) and why


def test_tree_bound_counts_every_permutation_of_the_prove(proved):
    """trees.prove_trees' trees, counted by trees.tree_permutations, are
    the permutations of every Poseidon2 call of the prove: the four
    commits' trees and the FRI layers' (the challenger's permutations are
    Poseidon, not Poseidon2)."""
    c = proved["cell"]
    want = sum(trees.tree_permutations(t, "poseidon2") for t in
               trees.prove_trees(c.size, int(c.config["profile"]
                                             ["log_blowup"])))
    assert proved["permuted"] == want
