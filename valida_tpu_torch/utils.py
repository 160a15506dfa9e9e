"""Prover stage markers and host spans: a profiler range per stage or
span, an opt-in live stage log and an opt-in host wall-clock collection.

Counterpart of valida_tpu/utils.py.  The Rust prover marks its stages with
`tracing` spans; here each stage is a `torch.profiler.record_function`
range under the same names, visible in a `torch.profiler` trace on the
timeline of the device's kernels and copies.  `span(name)` is the same
range for host work that is no stage (execution, trace inputs, uploads,
fetches, host permutations, graph captures, serialization) or for one
chip's part of a stage (its main trace, its quotient): it stays out
of the stage log and the collection, and never waits for the GPU.  Both
open their range only while a profiler runs; without one a stage or span
costs one check.  `set_trace(True)` prints each stage's host wall-clock as
it ends, and `start_stage_collection` / `stop_stage_collection` gather it.
While either is on, a stage waits for the GPU at its end, so that its time
holds its device work and not only the time to queue it.  Unlike the JAX
package, no environment variable turns the log on.
"""

from __future__ import annotations

import contextlib
import time

import torch

_TRACE = False
_PROFILING = torch.autograd._profiler_enabled  # one C call
_DEPTH = 0
_COLLECT = None  # dict name -> [seconds, count, min_depth] when active


def set_trace(enabled: bool):
    """Print `[trace]{indent} {name}: {ms} ms` at the end of every stage
    (nested stages indented two spaces a level) while enabled."""
    global _TRACE
    _TRACE = enabled


def start_stage_collection():
    """Begin accumulating per-stage host wall-clock."""
    global _COLLECT
    _COLLECT = {}


def stop_stage_collection() -> dict:
    """-> {name: {"s": total_seconds, "n": calls}} for top-level stages
    (nested stages are excluded so the values sum to ~total prove time)."""
    global _COLLECT
    acc, _COLLECT = _COLLECT, None
    if not acc:
        return {}
    top = min(d for (_, _, d) in acc.values())
    return {
        name: {"s": s, "n": n}
        for name, (s, n, d) in acc.items() if d == top
    }


class span:
    """A host span: `with span(name):` opens a profiler range of that name
    while a profiler runs, and does nothing else.  Names say the layer
    first ("execute: native core", "trace inputs: cpu", "main trace: cpu",
    "quotient: cpu", "upload", "fetch", "poseidon: permute_host", "prove:
    transcript", "capture: lde", "serialize: cbor"); `span(None)` opens
    nothing."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if self.name is not None and _PROFILING():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None


@contextlib.contextmanager
def stage(name: str):
    """Stage marker.  Names follow the Rust prover's span names ("generate
    main traces", "commit to main traces", "generate permutation traces",
    "compute quotient polynomial", "commit to quotient chunks", ...)."""
    global _DEPTH
    trace, collect = _TRACE, _COLLECT
    timed = trace or collect is not None
    t0 = time.perf_counter() if timed else 0.0
    depth = _DEPTH
    _DEPTH += 1
    try:
        with span(name):
            yield
    finally:
        _DEPTH -= 1
        if timed:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if trace:
                print(f"[trace]{'  ' * depth} {name}: {dt * 1e3:.1f} ms",
                      flush=True)
            if collect is not None:
                ent = collect.setdefault(name, [0.0, 0, depth])
                ent[0] += dt
                ent[1] += 1
                ent[2] = min(ent[2], depth)
