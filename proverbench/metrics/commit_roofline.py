"""The commits' share of their roofline: roofline.commit_bound (the
configuration's shapes: the NTTs, the LDEs and the Keccak trees) over the
device-busy time inside the four commit stages, in %."""

import roofline

STAGES = ("commit to preprocessed traces", "commit to main traces",
          "commit to permutation traces", "commit to quotient chunks")


def read(ctx):
    busy = ctx.trace.busy_in(STAGES) if ctx.trace is not None else None
    if not busy or not ctx.jobs:
        return None
    least, _by = roofline.commit_bound(
        ctx.cell.size, int(ctx.cell.config["profile"]["log_blowup"]))
    return 100.0 * least * len(ctx.jobs) / busy
