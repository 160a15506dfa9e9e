"""Prover stage markers: a profiler range per stage and an opt-in host
wall-clock collection.

Counterpart of valida_tpu/utils.py.  The Rust prover marks its stages with
`tracing` spans; here each stage is a `torch.profiler.record_function`
range (visible in `torch.profiler` traces, free without a profiler) under
the same names, and `start_stage_collection` / `stop_stage_collection`
gather each stage's host wall-clock.  While collecting, a stage waits for
the GPU at its end, so that its time holds its device work and not only
the time to queue it.
"""

from __future__ import annotations

import contextlib
import time

import torch

_DEPTH = 0
_COLLECT = None  # dict name -> [seconds, count, min_depth] when active


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


@contextlib.contextmanager
def stage(name: str):
    """Stage marker.  Names follow the Rust prover's span names ("generate
    main traces", "commit to main traces", "generate permutation traces",
    "compute quotient polynomial", "commit to quotient chunks", ...)."""
    global _DEPTH
    collect = _COLLECT
    t0 = time.perf_counter() if collect is not None else 0.0
    depth = _DEPTH
    _DEPTH += 1
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        _DEPTH -= 1
        if collect is not None:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            ent = collect.setdefault(name, [0.0, 0, depth])
            ent[0] += time.perf_counter() - t0
            ent[1] += 1
            ent[2] = min(ent[2], depth)
