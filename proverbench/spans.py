"""What the per-layer metrics read of the program's host spans: the
`utils.span` ranges of valida_tpu_torch in a traced run's host ranges
(`trace.Trace.host`).  A count is the number of ranges of a span that
wraps one event; a time is the ranges' total duration.  Every function
returns None where the trace holds no such range (a program without the
span), so the metric is left out of the result line."""

from __future__ import annotations


def _matching(ctx, name: str, prefix: bool) -> list:
    """(start, end) of the host ranges named `name`, or whose name starts
    with it where `prefix` ("trace inputs: " for every chip's)."""
    if ctx.trace is None or not ctx.jobs:
        return []
    return [(s, e) for s, e, n in ctx.trace.host
            if (n.startswith(name) if prefix else n == name)]


def ms_per_job(ctx, name: str, prefix: bool = False) -> float | None:
    """Milliseconds a traced job spends in the span (no span of these
    names opens inside another)."""
    spans = _matching(ctx, name, prefix)
    if not spans:
        return None
    return 1e3 * sum(e - s for s, e in spans) / len(ctx.jobs)


def count_per_job(ctx, name: str, prefix: bool = False) -> float | None:
    """Ranges of the span a traced job."""
    spans = _matching(ctx, name, prefix)
    if not spans:
        return None
    return len(spans) / len(ctx.jobs)
