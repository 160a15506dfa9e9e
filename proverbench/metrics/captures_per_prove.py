"""CUDA graphs the staged prover captures a prove inside the window: the
number of spans "capture: <stage>", mean over the traced proves.  It
should read 0, since set-up's warm-up captured every stage.  None where
the program has no prover spans ("prove: ...") to tell 0 from
unmeasured."""

import spans


def read(ctx):
    if spans.count_per_job(ctx, "prove: ", prefix=True) is None:
        return None
    return spans.count_per_job(ctx, "capture: ", prefix=True) or 0.0
