"""Openings and FRI: device-busy milliseconds inside the stages from the
openings at zeta to the query openings, mean per prove."""

STAGES = ("open at zeta", "reduce openings", "FRI commit phase",
          "PoW grind", "query openings")


def read(ctx):
    busy = ctx.trace.busy_in(STAGES) if ctx.trace is not None else None
    if busy is None or not ctx.jobs:
        return None
    return 1e3 * busy / len(ctx.jobs)
