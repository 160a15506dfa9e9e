"""The quotient's share of its roofline: roofline.quotient_bound (frozen
counts of the configuration's constraint systems and shapes) over the
device-busy time inside the stage "compute quotient polynomial", in %."""

import roofline

STAGES = ("compute quotient polynomial",)


def read(ctx):
    busy = ctx.trace.busy_in(STAGES) if ctx.trace is not None else None
    if not busy or not ctx.jobs:
        return None
    least, _by = roofline.quotient_bound(ctx.cell.size)
    return 100.0 * least * len(ctx.jobs) / busy
