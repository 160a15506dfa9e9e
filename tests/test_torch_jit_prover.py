"""The port's staged prover (valida_tpu_torch.machine.jit_prover) on the
CPU: its proofs against the JAX package's numpy pins and the port's eager
prover, byte for byte, and its stages against their one-shot forms and
the host challenger.  The JAX package's own `prove_jit` is not run here
(its cold compiles take minutes on a CPU); the pins suffice because a
proof leaves the prover no choice (the proof-of-work witness is the first
hit), so the same transcript gives the same bytes.

On the CPU a stage runs its Python function.  Here, from a stage's second
call on, it runs under the capture rules (`_capture_rules`: a host copy, a
value read back or a host value made into a tensor raises), as a CUDA
graph replays what was captured after an eager first run."""

import hashlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tests.test_torch_basic import reference_basic_digest
from tests.test_torch_dist_prover import one_rank_mesh_prove
from tests.test_torch_machine import FIXTURE, reference_machine_digest
from valida_tpu_torch import convert
from valida_tpu_torch.air.types import Interaction, VPCol
from valida_tpu_torch.chips.chip import Chip
from valida_tpu_torch.core.config import default_config
from valida_tpu_torch.crypto import keccak, poseidon
from valida_tpu_torch.crypto import poseidon2 as p2
from valida_tpu_torch.crypto.challenger import DuplexChallenger
from valida_tpu_torch.field import babybear as bb
from valida_tpu_torch.machine import examples
from valida_tpu_torch.machine import jit_prover as jp
from valida_tpu_torch.machine.machine import Machine
from valida_tpu_torch.parallel.dryrun import run_ranks
from valida_tpu_torch.tooling.cli import main as cli_main
from valida_tpu_torch.tooling.serde import deserialize_proof, serialize_proof


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers run at once: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the capture rules: on while a stage runs under them, and the depth of
# kernel plain versions entered (a plain version stands in for a kernel,
# which the card runs inside the graph: the rules do not apply to it)
_RULES = {"on": False, "plain": 0}


class _CaptureRules(TorchDispatchMode):
    """What a CUDA graph cannot hold raises: a copy to the host or a value
    read back (`int(t)`, `bool(t)`, `torch.equal`), a shape that depends
    on the data (`nonzero`), and a host value made into a tensor
    (`torch.tensor`, `from_numpy`, a Python list as an index, a Python
    number assigned into a tensor), which a graph would copy from a stale
    host buffer at every replay, or refuses to copy at all."""

    _SYNCS = {torch.ops.aten._local_scalar_dense.default,
              torch.ops.aten.nonzero.default,
              torch.ops.aten.masked_select.default,
              torch.ops.aten.equal.default,
              torch.ops.aten.lift_fresh.default}

    def __init__(self, key):
        super().__init__()
        self.key = key

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not _RULES["plain"] and func in self._SYNCS:
            raise RuntimeError(f"stage {self.key[0]}: {func} cannot run in "
                               f"a captured graph")
        return func(*args, **(kwargs or {}))


@pytest.fixture(autouse=True, scope="module")
def _capture_rules():
    """The CPU stand-in for a capture: a stage's first CPU call runs
    freely (the card's eager first run); its later calls run under
    `_CaptureRules`, and `convert`'s host uploads and fetches raise in
    them, outside a kernel's plain version."""
    seen = set()
    call, check = jp.Stage.__call__, convert._check_transfer

    def stage_call(self, *args, **kw):
        leaves, _spec = jp._flatten(args)
        if self.key not in seen or any(
                t is not None and t.device.type != "cpu" for t in leaves):
            seen.add(self.key)
            return call(self, *args, **kw)
        _RULES["on"] = True
        try:
            with _CaptureRules(self.key):
                return call(self, *args, **kw)
        finally:
            _RULES["on"] = False

    def check_transfer(what, device):
        if _RULES["on"] and not _RULES["plain"]:
            raise RuntimeError(f"{what} inside a captured stage")
        check(what, device)

    def plain(fn):
        def inner(words):
            _RULES["plain"] += 1
            try:
                return fn(words)
            finally:
                _RULES["plain"] -= 1
        return inner

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jp.Stage, "__call__", stage_call)
        mp.setattr(convert, "_check_transfer", check_transfer)
        mp.setattr(keccak, "keccak256_words_plain",
                   plain(keccak.keccak256_words_plain))
        mp.setattr(p2, "hash_words_plain", plain(p2.hash_words_plain))
        yield


def _cpu_config(**kw):
    return default_config(device="cpu", **kw)


# name -> (machine factory, config, the JAX package's pin: a file of bytes
# or the SHA-256 its numpy path gives)
CASES = {
    "mini (fixture)": (lambda: examples.random_mini_machine(48, seed=3),
                       _cpu_config(num_queries=3, proof_of_work_bits=1),
                       ("file", FIXTURE)),
    "ragged keccak": (lambda: examples.random_ragged_machine(32, seed=7),
                      _cpu_config(hasher="keccak"),
                      ("ragged", 32, "keccak")),
    "ragged poseidon2": (lambda: examples.random_ragged_machine(32, seed=7),
                         _cpu_config(hasher="poseidon2"),
                         ("ragged", 32, "poseidon2")),
    "fib": (lambda: examples.run_program(examples.fib_program(), 0x1000),
            _cpu_config(), ("basic", "fib", "default")),
}


def _pin(pin) -> str:
    if pin[0] == "file":
        with open(pin[1], "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    if pin[0] == "ragged":
        return reference_machine_digest(pin[1], pin[2])
    return reference_basic_digest(pin[1], pin[2])


@pytest.fixture(scope="module")
def jit_proofs():
    """{case: (machine, config, prove_jit's bytes, its stage keys)}."""
    out = {}
    for name, (make, cfg, _pin_) in CASES.items():
        m = make()
        blob = serialize_proof(jp.prove_jit(m, cfg))
        out[name] = (m, cfg, blob, list(jp.STAGE_LOG))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_prove_jit_bytes(jit_proofs, case):
    """prove_jit's proof is the JAX package's (its pin) and the port's
    eager prover's, byte for byte; a second prove of a fresh machine of
    the same program, under the capture rules, gives them again."""
    make, cfg, pin = CASES[case]
    m, _cfg, blob, _keys = jit_proofs[case]
    assert hashlib.sha256(blob).hexdigest() == _pin(pin)
    assert serialize_proof(m.prove(cfg)) == blob
    assert serialize_proof(jp.prove_jit(make(), cfg)) == blob


@pytest.mark.parametrize("case", list(CASES))
def test_repeat_prove_calls_the_same_stages(jit_proofs, case):
    """warmup_jit returns the number of stage calls of one prove, and a
    later prove of a fresh machine of the same program calls the same
    stage keys in the same order (the graphs' tree of call sites is keyed
    by that order)."""
    make, _cfg, _pin_ = CASES[case]
    m, cfg, _blob, keys = jit_proofs[case]
    assert jp.warmup_jit(m, cfg) == len(keys)
    assert jp.STAGE_LOG == keys
    jp.prove_jit(make(), cfg)
    assert jp.STAGE_LOG == keys


@pytest.mark.parametrize("tiles, machine", [
    ({"TREE_FUSE_MAX": 4}, lambda: examples.random_mini_machine(16, seed=5)),
], ids=["tree levels"])
def test_chunked_stages_same_proof(monkeypatch, tiles, machine):
    """Merkle trees built a stage per level give the fused trees' proof,
    which is the eager prover's."""
    cfg = _cpu_config(num_queries=4, proof_of_work_bits=2)
    m = machine()
    want = serialize_proof(m.prove(cfg))
    assert serialize_proof(jp.prove_jit(m, cfg)) == want
    for k, v in tiles.items():
        monkeypatch.setattr(jp, k, v)
    keys_before = set(jp.STAGE_LOG)
    assert serialize_proof(jp.prove_jit(machine(), cfg)) == want
    tiled = set(jp.STAGE_LOG) - keys_before
    assert "hashpair" in {k[0] for k in tiled}


def test_ladder_challenge_stage_matches_host():
    """The FRI ladder's duplex round on the device (absorb a root, sample
    beta) is the host DuplexChallenger's for every entry buffer length."""
    rng = np.random.default_rng(7)
    for k0 in range(poseidon.WIDTH):
        host = DuplexChallenger()
        for v in rng.integers(0, bb.P, size=16 + k0, dtype=np.uint32):
            host.observe(int(v))
        assert len(host.input_buffer) == k0
        state = torch.tensor(host.state, dtype=torch.int32)
        pending = torch.tensor(host.input_buffer, dtype=torch.int32)
        root = rng.integers(0, 2**32, size=8, dtype=np.uint64)
        root_t = torch.from_numpy(root.astype(np.uint32).view(np.int32))
        stage = jp._ladder_challenge_stage(k0, poseidon.PARAM_SET)
        state2, beta_m = (stage(state, pending, root_t) if k0
                          else stage(state, root_t))
        host.observe_digest(root)
        assert tuple(bb.from_monty(beta_m).tolist()) == host.sample_ext()
        assert state2.tolist() == host.state


def test_ladder_entry_k0_matches_runtime(jit_proofs, monkeypatch):
    """The FRI ladder makes one challenge stage a layer: the first enters
    with the challenger's pending inputs (fewer than a permutation's
    width), every later one with an empty buffer; the proof's bytes stay
    the pinned ones."""
    seen = []
    stage = jp._ladder_challenge_stage

    def spy(k0, param_set, *mesh_key):
        seen.append(k0)
        return stage(k0, param_set, *mesh_key)

    monkeypatch.setattr(jp, "_ladder_challenge_stage", spy)
    m, cfg, blob, _keys = jit_proofs["fib"]
    assert serialize_proof(jp.prove_jit(m, cfg)) == blob
    monkeypatch.undo()
    layers = deserialize_proof(blob).opening_proof.fri.commit_phase_commits
    assert len(seen) == len(layers) > 1
    assert 0 <= seen[0] < poseidon.WIDTH
    assert set(seen[1:]) == {0}


class _VarRangeChip(Chip):
    """A range table whose preprocessed column holds the values in a
    machine's own order: the bus reads it, so a stale preprocessed trace
    breaks the LogUp balance."""

    name = "vrange"

    def __init__(self, order):
        self.order = list(order)
        self.counts = {}

    def width(self):
        return 1

    def generate_trace(self, machine):
        rows = np.zeros((examples.MAX, 1), dtype=np.uint32)
        for v, c in self.counts.items():
            rows[self.order.index(v), 0] = c
        return rows

    def preprocessed_trace(self):
        return np.array(self.order, dtype=np.uint32).reshape(examples.MAX, 1)

    def global_receives(self, machine):
        return [Interaction(fields=[VPCol.single_prep(0)],
                            count=VPCol.single_main(0),
                            bus=machine.range_bus())]


class _VarMachine(Machine):
    def __init__(self, pairs, order):
        self.sender = examples.SenderChip(pairs)
        self.vrange = _VarRangeChip(order)
        for a, b in pairs:
            for v in (a, b):
                self.vrange.counts[v] = self.vrange.counts.get(v, 0) + 1

    def chips(self):
        return [self.sender, self.vrange]

    def range_bus(self):
        return examples.RANGE_BUS


def test_preprocessed_trace_is_not_baked_in():
    """Two machines whose preprocessed traces have one shape and different
    contents, proved one after the other: the second prove reruns the
    first one's stages (on the card: replays its graphs) and still gives
    the eager prover's bytes, which verify."""
    cfg = _cpu_config(num_queries=4, proof_of_work_bits=2,
                      debug_checks=False)
    pairs = [(1, 2), (3, 4), (15, 0), (7, 7)] * 4
    blobs = []
    for order in (list(range(examples.MAX)),
                  list(reversed(range(examples.MAX)))):
        m = _VarMachine(pairs, order)
        proof = jp.prove_jit(m, cfg)
        m.verify(cfg, proof)
        blobs.append(serialize_proof(proof))
        assert blobs[-1] == serialize_proof(m.prove(cfg))
    assert blobs[0] != blobs[1]


def test_capture_rules_on_the_cpu():
    """A stage's first CPU call runs freely (the card's eager first run);
    later calls raise on what a graph cannot hold."""
    x = torch.arange(4, dtype=torch.int32)
    for i, fn in enumerate([lambda t: t + torch.tensor([1, 2, 3, 4]),
                            lambda t: t * int(t.sum()),
                            lambda t: t[t.nonzero()[:, 0]],
                            lambda t: t.index_fill(0, torch.arange(1), 7)
                            .__setitem__(0, 5)]):
        stage = jp.Stage(("capture rules test", i), fn)
        stage(x)
        with pytest.raises(RuntimeError, match="captured"):
            stage(x)
    ok = jp.Stage(("capture rules test", "ok"), lambda t: bb.mul(t, 7))
    assert torch.equal(ok(x), ok(x))


def test_prove_jit_needs_a_gpu_here():
    """The default device is the card: without one, no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    m = examples.random_mini_machine(8, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        jp.prove_jit(m, default_config())
    with pytest.raises(RuntimeError, match="cuda"):
        jp.warmup_jit(m, default_config())


@pytest.fixture(scope="module")
def one_rank_mesh():
    """The fixture's machine proved on a one-rank gloo mesh, in a process
    of its own (`one_rank_mesh_prove`)."""
    return run_ranks(one_rank_mesh_prove, 1, "cpu", timeout_s=300)[0]


@pytest.mark.parametrize("entry", ["prove_jit", "warmup_jit", "row_axis"])
def test_one_rank_mesh(jit_proofs, one_rank_mesh, entry):
    """prove_jit(mesh=) on one rank gives the single-device bytes;
    warmup_jit(mesh=) calls the stages of that prove, in its order, and
    counts them, all keyed by the mesh, so no single-device graph is
    replayed; a row axis the mesh lacks raises."""
    _m, _cfg, blob, single_keys = jit_proofs["mini (fixture)"]
    mesh_blob, keys, (count, warm_keys), errors = one_rank_mesh
    if entry == "prove_jit":
        assert mesh_blob == blob
    elif entry == "warmup_jit":
        assert warm_keys == keys and count == len(keys)
        assert all(k[-1] == ("mesh", 1, "sp") for k in keys)
        assert len(keys) > len(single_keys)  # the tree tops and gathers
    else:
        assert len(errors) == 2
        assert all("no axis 'tp'" in e for e in errors)


def test_cli_prove_jit_writes_the_same_proof(tmp_path):
    """`prove --device cpu --jit` (one prove_jit) writes the file `prove --device cpu` writes (each prove verifies its proof)."""
    prog, proofs = tmp_path / "prog.bin", []
    assert cli_main(["asm", "tests/programs/subtraction.val", str(prog)]) == 0
    for flags in ([], ["--jit"]):
        out = tmp_path / f"proof{len(proofs)}.cbor"
        assert cli_main(["prove", str(prog), str(out), "--device", "cpu",
                         "--no-debug-checks"] + flags) == 0
        proofs.append(out.read_bytes())
    assert proofs[0] == proofs[1]


def test_transfer_stats(jit_proofs, monkeypatch):
    """`transfer_stats` counts the bytes of every host array a prove
    uploads, the traces and trace inputs among them, and a prove starts it
    at 0 (the JAX package's `transfer_stats["bytes"]`)."""
    m, cfg, blob, _keys = jit_proofs["fib"]
    uploads = []

    def counted(arr, device="cpu"):
        t = convert.from_reference(arr, device)
        uploads.append(t.nbytes)
        return t

    monkeypatch.setattr(jp, "from_reference", counted)
    trace_bytes = 0
    for c in m.chips():
        dti = c.device_trace_inputs(m)
        arrays = dti[0] if dti is not None else [c.generate_trace(m)]
        trace_bytes += sum(4 * np.asarray(a).size for a in arrays)
    for _ in range(2):
        uploads.clear()
        assert serialize_proof(jp.prove_jit(m, cfg)) == blob
        assert jp.transfer_stats == {"bytes": sum(uploads)}
        assert 0 < trace_bytes < sum(uploads)
