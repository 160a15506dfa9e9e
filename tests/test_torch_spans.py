"""The port's host spans (`valida_tpu_torch.utils.span`) on the CPU: one
execution by the C++ core, one `prove_jit` and one serialization of a
golden program profiled under `torch.profiler`, and the same three with no
profiler.  The spans name the host work the card waits on; they must not
change a proof's bytes, the stage collection, or cost a
`record_function` without a profiler.  The spans of uploads, fetches and
graph captures exist only on the card: proverbench/tests/
test_proverbench_spans.py holds them there.  About 25 s, most of it the
profiled prove and reading its trace back."""

import hashlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.test_torch_basic import program
from tests.test_torch_golden import DIGESTS
from valida_tpu_torch import utils
from valida_tpu_torch.core import config
from valida_tpu_torch.core.program import ProgramROM
from valida_tpu_torch.crypto import challenger, poseidon
from valida_tpu_torch.machine import examples
from valida_tpu_torch.machine import jit_prover as jp
from valida_tpu_torch.machine.basic import BasicMachine
from valida_tpu_torch.tooling.serde import serialize_proof

# a golden program that loads static data (the native core's whole set-up)
GOLDEN = "static_data"
JOB = ("job: execute", "job: prove", "job: serialize")
STAGES = {"generate main traces", "commit to preprocessed traces",
          "commit to main traces", "generate permutation traces",
          "commit to permutation traces",
          "compute quotient polynomial", "commit to quotient chunks",
          "open at zeta", "reduce openings", "FRI commit phase", "PoW grind",
          "query openings"}
PROVE_SPANS = ("prove: setup", "prove: preprocessed traces",
               "prove: transcript", "prove: direct polys",
               "prove: open direct", "prove: observe openings",
               "prove: final poly", "prove: query indices",
               "prove: assemble proof")
HOST_SPANS = ("execute: native core", "execute: op logs",
              "execute: range checks", "poseidon: permute_host",
              "serialize: to object", "serialize: cbor") + PROVE_SPANS


def native_machine(name: str):
    """The golden program's BasicMachine after `run_native`, op logs as
    arrays (as the benchmark executes its jobs)."""
    rows, fp, static = program(name)
    m = BasicMachine()
    m.program().set_program_rom(ProgramROM(
        [examples.instruction(op, *ops) for op, ops in rows]))
    for addr, value in (static or {}).items():
        m.static_data().write(addr, value)
    m.cpu().fp = fp
    m.run_native(build_lists=False)
    return m


def _job(name: str, cfg, ranges: bool):
    """Execute, prove (stage collection on) and serialize, each inside a
    `job: ...` range when `ranges`: (machine, stage collection, bytes)."""
    def within(label):
        return (torch.profiler.record_function(label) if ranges
                else utils.span(label))

    with within(JOB[0]):
        m = native_machine(name)
    utils.start_stage_collection()
    with within(JOB[1]):
        proof = jp.prove_jit(m, cfg)
    stages = utils.stop_stage_collection()
    with within(JOB[2]):
        blob = serialize_proof(proof)
    return m, stages, blob


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"plain": (stages, bytes, record_function entries),
    "profiled": (machine, stages, bytes, the Chrome trace's host ranges,
    permute_host calls)}."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = config.test_config(debug_checks=False, device="cpu")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        entered = []
        rf = torch.profiler.record_function

        def counted(name, *a):
            entered.append(name)
            return rf(name, *a)

        mp.setattr(torch.profiler, "record_function", counted)
        _m, stages, blob = _job(GOLDEN, cfg, ranges=False)
        out["plain"] = (stages, blob, list(entered))

    with pytest.MonkeyPatch.context() as mp:
        calls = []
        permute = poseidon.permute_host

        def permute_counted(state):
            calls.append(1)
            return permute(state)

        mp.setattr(poseidon, "permute_host", permute_counted)
        mp.setattr(challenger, "permute_host", permute_counted)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            m, stages, blob = _job(GOLDEN, cfg, ranges=True)
        path = tmp_path_factory.mktemp("spans") / "trace.json"
        prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    out["profiled"] = (m, stages, blob, host, len(calls))
    torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("name", HOST_SPANS + ("trace inputs: <chip>",))
def test_span_in_the_trace(runs, name):
    """Every span of the host's work is in the exported trace; a trace
    input's span for every chip, by the chip's name."""
    m, _stages, _blob, host, _calls = runs["profiled"]
    names = {n for _s, _e, n in host}
    if name == "trace inputs: <chip>":
        want = {f"trace inputs: {c.name}" for c in m.chips()}
        assert len(want) == 15 and want <= names
    else:
        assert name in names


def test_permute_host_spans_count_the_permutations(runs):
    """One span "poseidon: permute_host" for every host permutation."""
    _m, _stages, _blob, host, calls = runs["profiled"]
    spans = sum(n == "poseidon: permute_host" for _s, _e, n in host)
    assert calls > 100 and spans == calls


def test_stages_and_prove_spans_cover_the_prove(runs):
    """The stages and the spans "prove: ..." cover at least 95% of the
    prove's host range: the prover's host time outside them is named."""
    _m, stages, _blob, host, _calls = runs["profiled"]
    (p0, p1), = [(s, e) for s, e, n in host if n == JOB[1]]
    inside = sorted((s, e) for s, e, n in host
                    if p0 <= s and e <= p1
                    and (n in stages or n.startswith("prove: ")))
    covered, end = 0.0, p0
    for s, e in inside:
        if e > end:
            covered += e - max(s, end)
            end = e
    assert covered >= 0.95 * (p1 - p0)


def test_no_profiler_no_range_and_the_same_bytes(runs):
    """With no profiler a span or stage enters no `record_function`, and
    with or without one the proof's bytes are the golden program's pin
    (the JAX package's bytes)."""
    _stages, blob, entered = runs["plain"]
    assert entered == []
    assert hashlib.sha256(blob).hexdigest() == DIGESTS[GOLDEN]
    assert runs["profiled"][2] == blob


def test_stage_collection_unchanged_by_spans(runs):
    """`stop_stage_collection()` gives the same top-level stages, called as
    often, with the spans' ranges open as without them."""
    plain, _blob, _entered = runs["plain"]
    profiled = runs["profiled"][1]
    assert set(plain) == set(profiled) == STAGES
    assert {k: v["n"] for k, v in plain.items()} == \
        {k: v["n"] for k, v in profiled.items()}


def test_span_nests_and_passes_exceptions():
    """A span inside a stage and a stage inside a span each give their own
    range; an exception leaves both closed and propagates."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with utils.span("outer span"), utils.stage("inner stage"):
                with utils.span("innermost span"):
                    raise ValueError("through every range")
    names = [e.name for e in prof.events()]
    for n in ("outer span", "inner stage", "innermost span"):
        assert names.count(n) == 1
    assert not torch.autograd._profiler_enabled()

