"""The readers of the program's host spans (proverbench/spans.py and the
metrics that use it) on synthetic events, as the trace reduction's test
reads them; and the spans themselves in a prove on the card."""

import pytest

import run
import spec
import trace

SEED = 2**33 + 303


def _span_window(with_spans: bool = True):
    """A traced window of two jobs: the harness's job ranges, and inside
    them the program's spans (none where `with_spans` is off, as a
    program without them traces)."""
    us = 1e6
    X = lambda cat, name, s, d: {"ph": "X", "cat": cat, "name": name,
                                 "ts": s * us, "dur": d * us}
    events = [X("user_annotation", trace.WINDOW, 0.0, 20.0)]
    spans = []
    for j0 in (0.0, 10.0):
        events += [X("user_annotation", "job: execute", j0, 2.0),
                   X("user_annotation", "job: prove", j0 + 2.0, 6.0),
                   X("user_annotation", "job: serialize", j0 + 8.0, 1.5),
                   X("kernel", "keccak256", j0 + 3.0, 1.0)]
        spans += [X("user_annotation", "execute: native core", j0, 1.0),
                  X("user_annotation", "execute: range checks", j0 + 1.0,
                    0.5),
                  X("user_annotation", "generate main traces", j0 + 2.0,
                    1.0),
                  X("user_annotation", "trace inputs: cpu", j0 + 2.0, 0.25),
                  X("user_annotation", "trace inputs: mem", j0 + 2.25, 0.5),
                  X("user_annotation", "prove: transcript", j0 + 5.0, 2.0),
                  X("user_annotation", "serialize: to object", j0 + 8.0,
                    0.5),
                  X("user_annotation", "serialize: cbor", j0 + 8.5, 1.0)]
        spans += [X("user_annotation", "poseidon: permute_host",
                    j0 + 5.0 + 0.1 * i, 0.05) for i in range(3)]
    spans.append(X("user_annotation", "capture: lde", 12.75, 0.25))
    if with_spans:
        events += spans
    c = spec.cell(spec.benchmark(), "fibonacci.short10")
    return run.Window(c, [None, None], 20.0, 1.0, 0, trace.Trace(events))


SPAN_METRICS = {
    "native_core_ms": 1000.0,
    "range_checks_ms": 500.0,
    "trace_inputs_ms": 750.0,
    "permute_host_ms": 150.0,
    "host_permutations_per_prove": 3.0,
    "serialize_ms": 1500.0,
    "captures_per_prove": 0.5,  # one capture in two proves
    # idle [0, 3) [4, 13) [14, 20): 18 s; a job range innermost or none
    # over [1.5, 2) [4, 5) [7, 8) [9.5, 10) of each job: 3 s a job
    "idle_unspanned_share": 100.0 * 6.0 / 18.0,
}


@pytest.mark.parametrize("name", list(SPAN_METRICS))
def test_span_metric_reads_synthetic_spans(name):
    """Each reader of the program's spans on synthetic events, per job;
    without the spans (a program that lacks them) each returns None, but
    the idle share, which then reads every idle second as unnamed."""
    read = spec.metric_reader(name)
    assert read(_span_window()) == pytest.approx(SPAN_METRICS[name])
    bare = read(_span_window(with_spans=False))
    if name == "idle_unspanned_share":
        assert bare == pytest.approx(100.0)
    else:
        assert bare is None


def test_captures_read_zero_when_none_ran():
    """captures_per_prove reads 0, not None, where the prover's spans are
    there and no capture is."""
    ctx = _span_window()
    ctx.trace.host = [h for h in ctx.trace.host
                      if not h[2].startswith("capture: ")]
    assert spec.metric_reader("captures_per_prove")(ctx) == 0.0


@pytest.mark.card
def test_spans_on_the_card(card, small_cell):
    """On the card a prove with no graphs captures its stages ("capture:
    ...") and a warm prove of the next job captures none; both upload
    ("upload") and fetch ("fetch"), and every span of the host's work is
    in the profiler's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import port
    from valida_tpu_torch.machine import jit_prover

    port.build("cuda")
    cfg = port.prover_config(small_cell.config["profile"], "cuda")
    jit_prover.release_graphs()
    names = []
    for index in (0, 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            m = port.execute(spec.job_program(small_cell, SEED, index),
                             small_cell.program["fp"])
            port.serialize(port.prove(m, cfg), cfg)
            torch.cuda.synchronize()
        names.append({e.name for e in prof.events()})
    jit_prover.release_graphs()
    captures = [{n for n in ns if n.startswith("capture: ")} for ns in names]
    assert captures[0] and not captures[1]
    want = {"upload", "fetch", "execute: native core", "execute: op logs",
            "execute: range checks", "poseidon: permute_host",
            "prove: setup", "prove: transcript", "prove: observe openings",
            "prove: assemble proof", "serialize: to object",
            "serialize: cbor"} | {f"trace inputs: {c.name}"
                                  for c in m.chips()}
    assert want <= names[0] and want <= names[1]
