"""The port's distributed staged prover (`prove_jit(mesh=)`,
`warmup_jit(mesh=)`) on gloo ranks on the CPU: every rank's proof is, byte
for byte, the port's single-device `prove_jit` proof and the JAX package's
numpy prover's (its SHA-256, pinned), and the JAX package's verifier
accepts it.  The cases are the JAX package's own (tests/test_dist_prover.py:
`random_mini_machine(512, seed=3)`, `random_ragged_machine(512, seed=5)`,
whose heights 512/64/16/1, preprocessed matrix and 1-row trace give sharded
matrices extended by `dist_dif`, gathered ones, whole ones and tree
injections), one under Poseidon2 trees, one at blowup 4 (the quotient
domain is the first half of each LDE, so its rows are redistributed), one
with a final polynomial of 16 coefficients (the 16-row chip's matrices are
opened directly, their coefficients gathered), one with the debug checks on
(the whole traces gathered outside the stages), fib on the BasicMachine,
and the mini machine at 1024 rows on 8 ranks.  Each case's reference
digest is computed live by the JAX package's numpy prover, and checked
against its pin too.

Ranks are spawned once per world size (a module fixture), every case of
that size proved in them; results come back through files (`run_ranks`).
The JAX package is imported only in this process, inside the reference
functions, so the ranks never load it.
"""

import functools
import hashlib
import sys

import pytest
import torch

from valida_tpu_torch.core.config import default_config
from valida_tpu_torch.machine import examples
from valida_tpu_torch.machine import jit_prover as jp
from valida_tpu_torch.parallel import dist_ntt
from valida_tpu_torch.parallel.dryrun import prove_multichip, run_ranks
from valida_tpu_torch.parallel.mesh import make_mesh
from valida_tpu_torch.tooling.serde import serialize_proof

RANK_TIMEOUT_S = 300
DRYRUN_LOG_CYCLES = 10  # `dryrun --prove`'s ALU loop, on the 2 ranks
TEST_CONFIG = dict(num_queries=4, proof_of_work_bits=2, debug_checks=False)

# name -> (machine: kind and arguments, default_config's keywords beside
# TEST_CONFIG's, which they override)
CASES = {
    "mini": (("mini", 512, 3), {}),
    "ragged": (("ragged", 512, 5), {}),
    "ragged poseidon2": (("ragged", 512, 5), {"hasher": "poseidon2"}),
    "ragged blowup 4": (("ragged", 512, 5), {"log_blowup": 2}),
    "ragged final poly": (("ragged", 512, 5), {"log_final": 4}),
    "ragged checks": (("ragged", 512, 5), {"debug_checks": True}),
    "fib": (("fib",), {}),
    "mini 1024": (("mini", 1024, 3), {}),
}
RUNS = [(2, "mini"), (2, "ragged"), (2, "ragged poseidon2"), (2, "fib"),
        (2, "ragged checks"),
        (4, "mini"), (4, "ragged"), (4, "ragged blowup 4"),
        (4, "ragged final poly"), (8, "mini 1024")]

# SHA-256 of each case's proof as the JAX package's numpy path makes it
# (`reference_digest`, which each test also runs live)
PINS = {
    "mini": "8268dfb46ecbbd0c553358ef3c5f476cbecd35698c9cd2aa4ed291a07ae2aa67",
    "ragged":
        "8db8e6bad5099d65bbe0c80471a36b52bc5b90ced9783461f1de76600c50556c",
    "ragged poseidon2":
        "d94946a751e09bf274e5180ce7ba3cc43fa1ddb06e9708c73e3b63f6d1a75be1",
    "ragged blowup 4":
        "679515541c6d609624c53398102fd6dfeea72e5483c7b78200aa913af4f10b63",
    "ragged final poly":
        "61ffda253c7fa12d3b355f0762b95ee2265343443b67fdfc848feb85d1a561f6",
    "ragged checks":  # the checks do not change the bytes
        "8db8e6bad5099d65bbe0c80471a36b52bc5b90ced9783461f1de76600c50556c",
    "fib": "edbf9943b5207502d4af925280548e1791a654a723dd166dba39d8929b3a7639",
    "mini 1024":
        "e67761345af118184cabb9a0319aa4dcfca922d24b19b9ea7e16046575fe5634",
}


def _machine(spec):
    if spec[0] == "fib":
        return examples.run_program(examples.fib_program(), 0x1000)
    make = {"mini": examples.random_mini_machine,
            "ragged": examples.random_ragged_machine}[spec[0]]
    return make(spec[1], seed=spec[2])


def _config(name):
    return default_config(device="cpu", **{**TEST_CONFIG, **CASES[name][1]})


def _rank_cases(world, names):
    """Run in each rank: every named case by prove_jit on a (1, world)
    mesh -> {name: its bytes, stage calls, warmup_jit(dry=True)'s count,
    whether dist_dif takes its tallest trace}."""
    if "jax" in sys.modules:
        raise RuntimeError("a rank imported jax")
    mesh = make_mesh(world, device="cpu")
    out = {}
    for name in names:
        m, cfg = _machine(CASES[name][0]), _config(name)
        proof = jp.prove_jit(m, cfg, mesh=mesh)
        out[name] = dict(
            blob=serialize_proof(proof), calls=len(jp.STAGE_LOG),
            dry=jp.warmup_jit(m, cfg, dry=True, mesh=mesh),
            applies=dist_ntt.dist_dif_applies(
                max(cp.log_degree for cp in proof.chip_proofs), mesh))
    if world == 2:
        out["dryrun --prove"] = prove_multichip(world, DRYRUN_LOG_CYCLES,
                                                "cpu")
    if "jax" in sys.modules:
        raise RuntimeError("a rank imported jax")
    return out


def one_rank_mesh_prove():
    """Run in one gloo rank: the golden fixture's machine and config
    (tests/fixtures/mini_proof_v1.cbor) by prove_jit and warmup_jit on a
    one-rank mesh -> (the proof's bytes, its stage keys, the mesh plan's
    keys, warmup_jit's counts dry and not, the errors of a row axis the
    mesh lacks)."""
    mesh = make_mesh(1, device="cpu")
    m = examples.random_mini_machine(48, seed=3)
    cfg = default_config(num_queries=3, proof_of_work_bits=1, device="cpu")
    blob = serialize_proof(jp.prove_jit(m, cfg, mesh=mesh))
    keys = list(jp.STAGE_LOG)
    plan = jp._plan(m, cfg, ("mesh", 1, "sp"))
    counts = (jp.warmup_jit(m, cfg, dry=True, mesh=mesh),
              jp.warmup_jit(m, cfg, mesh=mesh))
    errors = []
    for call in (lambda: jp.prove_jit(m, cfg, mesh=mesh, row_axis="tp"),
                 lambda: jp.warmup_jit(m, cfg, dry=True, mesh=mesh,
                                       row_axis="tp")):
        try:
            call()
        except ValueError as e:
            errors.append(str(e))
    return blob, keys, plan, counts, errors


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers run at once: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks():
    """results(world) -> [each rank's {case: result}], ranks spawned once
    per world size."""
    cache = {}

    def results(world):
        if world not in cache:
            cache[world] = run_ranks(
                _rank_cases, world, "cpu", world,
                [name for w, name in RUNS if w == world],
                timeout_s=RANK_TIMEOUT_S)
        return cache[world]

    return results


@pytest.fixture(scope="module")
def single():
    """blob(name) -> the port's single-process prove_jit bytes of a case,
    made once; verified(name, blob) -> the JAX package's verifier run once
    on those bytes."""
    blobs, verified = {}, set()

    def blob(name):
        if name not in blobs:
            blobs[name] = serialize_proof(jp.prove_jit(
                _machine(CASES[name][0]), _config(name)))
        return blobs[name]

    def verify(name, data):
        if (name, data) not in verified:
            reference_verify(name, data)
            verified.add((name, data))

    return blob, verify


def _reference(name):
    """The JAX package's machine and config of a case."""
    from valida_tpu.core import config as rconfig
    from valida_tpu.machine import examples as rexamples

    spec, kw = CASES[name]
    if spec[0] == "fib":
        from tests.test_torch_basic import reference_machine

        m = reference_machine("fib")
    else:
        make = {"mini": rexamples.random_mini_machine,
                "ragged": rexamples.random_ragged_machine}[spec[0]]
        m = make(spec[1], seed=spec[2])
    return m, rconfig.default_config(**{**TEST_CONFIG, **kw})


@functools.lru_cache(maxsize=None)
def reference_digest(name) -> str:
    """SHA-256 of the case's proof as the JAX package's numpy path makes
    it (PINS; 1-5 s each, made once a process)."""
    from valida_tpu import backend
    from valida_tpu.tooling import serde as rserde

    m, cfg = _reference(name)
    with backend.use_backend("numpy"):
        proof = m.prove(cfg)
    return hashlib.sha256(rserde.serialize_proof(proof)).hexdigest()


def reference_verify(name, blob) -> None:
    """The JAX package's verifier on the deserialized bytes (raises)."""
    from valida_tpu import backend
    from valida_tpu.tooling import serde as rserde

    m, cfg = _reference(name)
    with backend.use_backend("numpy"):
        m.verify(cfg, rserde.deserialize_proof(blob))


@pytest.mark.parametrize("world,name", RUNS,
                         ids=[f"{w} ranks-{n}" for w, n in RUNS])
def test_mesh_prove_is_the_single_device_proof(ranks, single, world, name):
    """Every rank's bytes are the same, the port's single-device
    prove_jit's and the JAX package's (its digest made live, and pinned);
    its verifier accepts them;
    warmup_jit(dry=True) counts the mesh prove's stage calls; and the
    tallest trace takes the distributed NTT."""
    blob_of, verify = single
    per_rank = [r[name] for r in ranks(world)]
    blob = per_rank[0]["blob"]
    assert all(r["blob"] == blob for r in per_rank)
    assert blob == blob_of(name)
    assert hashlib.sha256(blob).hexdigest() == reference_digest(name)
    assert PINS[name] == reference_digest(name)
    assert all(r["calls"] == r["dry"] for r in per_rank)
    assert all(r["applies"] for r in per_rank)
    verify(name, blob)


def test_dryrun_prove_mode(ranks):
    """`dryrun N --prove LOG_CYCLES`'s rank function: the ALU loop by the
    C++ core, proved on the mesh, gives every rank the single-device
    prove_jit's bytes."""
    from valida_tpu_torch.core.program import ProgramROM
    from valida_tpu_torch.machine.basic import BasicMachine

    m = BasicMachine()
    m.program().set_program_rom(ProgramROM(
        examples.alu_loop_program((1 << DRYRUN_LOG_CYCLES) // 14)))
    m.cpu().fp = 0x1000000
    m.run_native(build_lists=False)
    want = hashlib.sha256(serialize_proof(jp.prove_jit(
        m, default_config(debug_checks=False, device="cpu")))).hexdigest()
    assert [r["dryrun --prove"][0] for r in ranks(2)] == [want, want]
