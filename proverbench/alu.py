"""What the metrics of the u32 ALU chips read of a traced run: the chips
as the port names them, and the device-busy time inside their per-chip
ranges ("main trace: <chip>", "quotient: <chip>"; the device ranges of
the program's spans that wrap the replay of each chip's trace or quotient
stage, and not its uploads or the copies into the graph's inputs).
Nothing here imports the program under test."""

from __future__ import annotations

CHIPS = ("add_u32", "sub_u32", "mul_u32", "div_u32", "shift_u32", "lt_u32",
         "com_u32", "bitwise_u32")


def busy_s(ctx, prefix: str) -> float | None:
    """Device-busy seconds over the traced proves inside the device ranges
    `prefix` + chip; None where the trace holds none of them."""
    if ctx.trace is None or not ctx.jobs:
        return None
    return ctx.trace.busy_in(tuple(prefix + chip for chip in CHIPS))
