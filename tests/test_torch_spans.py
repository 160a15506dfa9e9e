"""The port's host spans (`valida_tpu_torch.utils.span`) on the CPU: one
execution by the C++ core, one `prove_jit` and one serialization of a
golden program profiled under `torch.profiler`, and the same three with no
profiler.  The spans name the host work the card waits on; they must not
change a proof's bytes, the stage collection, or cost a
`record_function` without a profiler; the memory chip's sort runs inside
"execute: range checks".  The spans of uploads, fetches and
graph captures exist only on the card: proverbench/tests/
test_proverbench_spans.py holds them there.  Each Merkle tree the prove
builds opens one range "merkle: <tree>" inside its stage.  Last, the
benchmark's readers of the u32 ALU chips' spans and ranges
(proverbench/metrics/alu_*.py), of the trees' ranges
(merkle_busy_ms.py, merkle_roofline.py, by proverbench/trees.py) and of
the grind's counter (grind_candidates_per_prove.py) on synthetic events,
and the counter in a grind.  About 25 s, most of it the profiled prove
and reading its trace back."""

import contextlib
import hashlib
import importlib.util
import json
import sys
import types
from pathlib import Path

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
from valida_tpu_torch.machine import basic
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
# a span for each chip's call inside these stages
CHIP_SPANS = {"main trace: ": "generate main traces",
              "quotient: ": "compute quotient polynomial"}


def loaded_machine(name: str):
    """The golden program's BasicMachine, loaded and not yet run."""
    rows, fp, static = program(name)
    m = BasicMachine()
    m.program().set_program_rom(ProgramROM(
        [examples.instruction(op, *ops) for op, ops in rows]))
    for addr, value in (static or {}).items():
        m.static_data().write(addr, value)
    m.cpu().fp = fp
    return m


def native_machine(name: str):
    """The golden program's BasicMachine after `run_native`, op logs as
    arrays (as the benchmark executes its jobs)."""
    m = loaded_machine(name)
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


@pytest.mark.parametrize("prefix", list(CHIP_SPANS))
def test_one_chip_span_a_chip_inside_its_stage(runs, prefix):
    """A profiled prove opens one range `prefix` + chip for each chip that
    runs a stage function there (every chip's quotient; the main trace of
    each chip with a device trace builder), each inside its stage's range,
    but for the last chip (byte): the stage keeps its run, so that the
    stage's own range on the card's timeline ends with its last replay.
    With no profiler it opens none."""
    m, _stages, _blob, host, _calls = runs["profiled"]
    chips = m.chips()
    staged = [c for c in chips if prefix == "quotient: "
              or c.device_trace_inputs(m) is not None]
    assert chips[-1].name == "byte" and chips[-1] in staged
    ranges = [(s, e, n) for s, e, n in host if n.startswith(prefix)]
    assert sorted(n for _s, _e, n in ranges) == sorted(
        f"{prefix}{c.name}" for c in staged[:-1])
    assert len(ranges) == (14 if prefix == "quotient: " else 10)
    (s0, e0), = [(s, e) for s, e, n in host if n == CHIP_SPANS[prefix]]
    assert all(s0 <= s and e <= e0 for s, e, _n in ranges)
    _stages, _blob, entered = runs["plain"]
    assert not [n for n in entered if n.startswith(prefix)]


def test_range_checks_span_holds_the_memory_sort(runs, monkeypatch):
    """A profiled execution opens "execute: range checks" once; and the
    memory chip's sort (its rows, made with the range counts) runs inside
    that span: the rows are not there when it opens and are when it
    closes, so no part of it moves out of the measured stretch."""
    _m, _stages, _blob, host, _calls = runs["profiled"]
    assert sum(n == "execute: range checks" for _s, _e, n in host) == 1
    m = loaded_machine(GOLDEN)
    seen = []
    span = basic.span

    @contextlib.contextmanager
    def watched(name):
        seen.append((name, "open", m.mem()._rows_cache is not None))
        with span(name):
            yield
        seen.append((name, "closed", m.mem()._rows_cache is not None))

    monkeypatch.setattr(basic, "span", watched)
    m.run_native(build_lists=False)
    assert seen == [("execute: range checks", "open", False),
                    ("execute: range checks", "closed", True)]
    assert m.mem().ops_arrays is not None


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


# -- the benchmark's readers of the u32 ALU chips ---------------------------

BENCH = Path(__file__).resolve().parents[1] / "proverbench"
ALU_CHIPS = ("add_u32", "sub_u32", "mul_u32", "div_u32", "shift_u32",
             "lt_u32", "com_u32", "bitwise_u32")


@pytest.fixture(scope="module")
def bench():
    """proverbench's `spec` and `roofline`, and its `trace` module (loaded
    by path: the standard library has a module of that name)."""
    if str(BENCH) not in sys.path:
        sys.path.append(str(BENCH))
    import roofline
    import spec

    loader = importlib.util.spec_from_file_location("proverbench_trace",
                                                    BENCH / "trace.py")
    trace = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(trace)
    return types.SimpleNamespace(spec=spec, roofline=roofline, trace=trace)


def _alu_window(bench, with_spans: bool = True):
    """A traced window of two proves of sha2_chain.seg21: in each, the
    trace inputs of cpu, bitwise_u32 and shift_u32 on the host, and on the
    card the main traces of cpu and bitwise_u32 and the quotients of cpu
    and shift_u32, each a range around one kernel; without `with_spans`
    (a program without the spans) only the jobs' ranges and the kernels."""
    us = 1e6
    X = lambda cat, name, s, d: {"ph": "X", "cat": cat, "name": name,
                                 "ts": s * us, "dur": d * us}
    events = [X("user_annotation", bench.trace.WINDOW, 0.0, 20.0)]
    for j0 in (0.0, 10.0):
        events += [X("user_annotation", "job: prove", j0 + 1.0, 8.0),
                   X("kernel", "build_trace", j0 + 2.0, 0.5),
                   X("kernel", "build_trace", j0 + 2.5, 0.25),
                   X("kernel", "constraint_eval", j0 + 4.0, 1.0),
                   X("kernel", "constraint_eval", j0 + 5.0, 0.375)]
        if with_spans:
            events += [
                X("user_annotation", "trace inputs: cpu", j0 + 1.0, 0.5),
                X("user_annotation", "trace inputs: bitwise_u32", j0 + 1.5,
                  0.25),
                X("user_annotation", "trace inputs: shift_u32", j0 + 1.75,
                  0.125),
                X("gpu_user_annotation", "main trace: cpu", j0 + 2.0, 0.5),
                X("gpu_user_annotation", "main trace: bitwise_u32", j0 + 2.5,
                  0.25),
                X("gpu_user_annotation", "quotient: cpu", j0 + 4.0, 1.0),
                X("gpu_user_annotation", "quotient: shift_u32", j0 + 5.0,
                  0.375)]
    c = bench.spec.cell(bench.spec.benchmark(), "sha2_chain.seg21")
    return types.SimpleNamespace(cell=c, jobs=[None, None],
                                 trace=bench.trace.Trace(events))


def _alu_bound(bench, size: dict) -> float:
    """roofline.quotient_bound's least seconds for the u32 ALU chips."""
    return bench.roofline.quotient_bound(
        {"chips": {k: size["chips"][k] for k in ALU_CHIPS}})[0]


# per prove; the roofline (None): 100 × the ALU chips' bound over the
# shift_u32 kernel's 0.375 s
ALU_METRICS = {
    "alu_trace_inputs_ms": 375.0,  # bitwise_u32 250 + shift_u32 125
    "alu_traces_busy_ms": 250.0,  # bitwise_u32's kernel
    "alu_quotient_busy_ms": 375.0,  # shift_u32's kernel
    "alu_quotient_roofline": None,
}


@pytest.mark.parametrize("name", list(ALU_METRICS))
def test_alu_metric_reads_synthetic_spans(bench, name):
    """Each reader sums the u32 ALU chips' spans or ranges and leaves the
    other chips' out, per prove; without the spans it returns None."""
    ctx = _alu_window(bench)
    want = ALU_METRICS[name]
    if want is None:
        want = 100.0 * _alu_bound(bench, ctx.cell.size) / 0.375
    read = bench.spec.metric_reader(name)
    assert read(ctx) == pytest.approx(want)
    assert read(_alu_window(bench, with_spans=False)) is None


def test_alu_quotient_roofline_counts_only_the_alu_chips(bench):
    """The ALU roofline's bound is quotient_bound of the u32 ALU chips
    alone: less than the whole configuration's, and more than any one
    chip's at height."""
    size = _alu_window(bench).cell.size
    alu = _alu_bound(bench, size)
    assert alu < bench.roofline.quotient_bound(size)[0]
    for chip in ("bitwise_u32", "shift_u32", "add_u32"):
        one = bench.roofline.quotient_bound(
            {"chips": {chip: size["chips"][chip]}})[0]
        assert 0 < one < alu


# -- the Merkle trees' spans and the benchmark's readers of them ------------

# the stage that encloses each tree's span
TREE_STAGES = {"merkle: preprocessed": "commit to preprocessed traces",
               "merkle: main": "commit to main traces",
               "merkle: permutation": "commit to permutation traces",
               "merkle: quotient chunks": "commit to quotient chunks",
               "merkle: FRI layer": "FRI commit phase"}


def test_one_merkle_span_a_tree_inside_its_stage(runs):
    """A profiled prove opens one range "merkle: <tree>" for each tree it
    builds (the four commits' and one a FRI layer), each inside its
    stage's range; with no profiler it opens none."""
    from valida_tpu_torch.tooling.serde import deserialize_proof

    _m, _stages, blob, host, _calls = runs["profiled"]
    layers = len(deserialize_proof(blob).opening_proof.fri
                 .commit_phase_commits)
    ranges = [(s, e, n) for s, e, n in host if n.startswith("merkle: ")]
    got = {}
    for _s, _e, n in ranges:
        got[n] = got.get(n, 0) + 1
    assert got == {n: (layers if n == "merkle: FRI layer" else 1)
                   for n in TREE_STAGES} and layers > 3
    for s, e, n in ranges:
        (s0, e0), = [(a, b) for a, b, m in host if m == TREE_STAGES[n]]
        assert s0 <= s and e <= e0
    _stages, _blob, entered = runs["plain"]
    assert not [n for n in entered if n.startswith("merkle: ")]


def _merkle_window(bench, cell: str, with_spans: bool = True):
    """A traced window of two proves of `cell`: in each, on the card, a
    leaf kernel and a compression kernel inside "merkle: main", a kernel
    inside "merkle: FRI layer" and an NTT outside both; without
    `with_spans` (a program without them) only the kernels."""
    us = 1e6
    X = lambda cat, name, s, d: {"ph": "X", "cat": cat, "name": name,
                                 "ts": s * us, "dur": d * us}
    events = [X("user_annotation", bench.trace.WINDOW, 0.0, 20.0)]
    for j0 in (0.0, 10.0):
        events += [X("user_annotation", "job: prove", j0 + 1.0, 8.0),
                   X("kernel", "ntt_dif_ragged", j0 + 1.5, 0.5),
                   X("kernel", "poseidon2", j0 + 2.0, 0.25),
                   X("kernel", "poseidon2", j0 + 2.25, 0.125),
                   X("kernel", "poseidon2", j0 + 6.0, 0.125)]
        if with_spans:
            events += [
                X("gpu_user_annotation", "merkle: main", j0 + 2.0, 0.375),
                X("gpu_user_annotation", "merkle: FRI layer", j0 + 6.0,
                  0.125)]
    c = bench.spec.cell(bench.spec.benchmark(), cell)
    return types.SimpleNamespace(cell=c, jobs=[None, None],
                                 trace=bench.trace.Trace(events))


@pytest.mark.parametrize("cell", ("fibonacci_poseidon2.seg21",
                                  "fibonacci.seg20"))
@pytest.mark.parametrize("name", ("merkle_busy_ms", "merkle_roofline"))
def test_merkle_metric_reads_synthetic_ranges(bench, name, cell):
    """The trees' busy time is the kernels inside the ranges "merkle:
    <tree>" (0.5 s a prove, the NTT left out); the roofline is the
    configuration's tree bound, by its profile's hasher, over it.
    Without the ranges both return None."""
    import trees

    ctx = _merkle_window(bench, cell)
    want = (500.0 if name == "merkle_busy_ms" else
            100.0 * trees.bound(ctx.cell.size,
                                ctx.cell.config["profile"])[0] / 0.5)
    read = bench.spec.metric_reader(name)
    assert read(ctx) == pytest.approx(want)
    assert read(_merkle_window(bench, cell, with_spans=False)) is None


def test_tree_bound_by_hasher(bench):
    """The bound's two branches: Keccak-f as roofline.py counts the trees
    (4,320 slots a permutation); Poseidon2 at chip_smoke.py's 3,150 slots
    a permutation, the `poseidon2` kernel's 3.1594 ms at 2^20 rows of 128
    words; both bounded by operations at the cell's shapes, Poseidon2's
    the larger."""
    import trees

    r = bench.roofline
    blocks, f_ops = trees.HASHERS["poseidon2"]
    assert (f_ops, blocks(128), blocks(16), blocks(15)) == (3150, 16, 2, 2)
    assert 1e3 * (1 << 20) * blocks(128) * f_ops / r.INT32_OPS_PER_S == \
        pytest.approx(3.1594, abs=1e-4)
    size = bench.spec.cell(bench.spec.benchmark(),
                           "fibonacci_poseidon2.seg21").size
    bounds = {}
    for hasher in ("keccak", "poseidon2"):
        profile = {"hasher": hasher, "log_blowup": 1}
        least, by = trees.bound(size, profile)
        perms = sum(trees.tree_permutations(t, hasher)
                    for t in trees.prove_trees(size, 1))
        assert by == "operations"
        assert least == pytest.approx(
            perms * trees.HASHERS[hasher][1] / r.INT32_OPS_PER_S)
        bounds[hasher] = least
    for mats in trees.prove_trees(size, 1):
        assert (trees.tree_permutations(mats, "keccak")
                == r.tree_permutations(mats))
    assert bounds["poseidon2"] > bounds["keccak"]


def test_grind_candidates_read_the_ports_counter(bench, monkeypatch):
    """grind_candidates_per_prove is the port's grind counter, candidates
    over grinds; None where the port has no such counter or no grind ran,
    as in a program without it."""
    from valida_tpu_torch.commit import fri

    read = bench.spec.metric_reader("grind_candidates_per_prove")
    monkeypatch.setattr(fri, "grind_stats",
                        {"grinds": 4, "candidates": 3 * 16384 + 114688})
    assert read(None) == pytest.approx((3 * 16384 + 114688) / 4)
    monkeypatch.setattr(fri, "grind_stats", {"grinds": 0, "candidates": 0})
    assert read(None) is None
    monkeypatch.delattr(fri, "grind_stats")
    assert read(None) is None


def test_grind_counts_every_candidate_it_permutes(monkeypatch):
    """grind_device adds one grind and every candidate of every batch it
    permuted (the last batch whole) to fri.grind_stats."""
    from valida_tpu_torch.commit import fri
    from valida_tpu_torch.crypto.challenger import DuplexChallenger

    monkeypatch.setattr(fri, "grind_stats", {"grinds": 0, "candidates": 0})
    permuted = []
    permute = poseidon.permute_device

    def counted(state):
        permuted.append(int(state.shape[0]))
        return permute(state)

    monkeypatch.setattr(poseidon, "permute_device", counted)
    ch = DuplexChallenger()
    ch.observe(12345)
    fri.grind_device(ch, 7, device="cpu")
    assert fri.grind_stats == {"grinds": 1, "candidates": sum(permuted)}
    assert permuted[0] == 512
