"""The trace builders: host milliseconds of the prover's stage "generate
main traces" (utils.start_stage_collection, which waits for the card at
the stage's end; traced run only), mean per prove."""

STAGE = "generate main traces"


def read(ctx):
    vals = [j.stages[STAGE] for j in ctx.jobs if STAGE in j.stages]
    if not vals:
        return None
    return 1e3 * sum(vals) / len(vals)
