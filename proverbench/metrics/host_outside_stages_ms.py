"""The staged prover's host time outside its stages (the challenger's
host permutations, fetches, the proof's assembly): a prove's wall-clock
minus the sum of its top-level stages' host times, mean per prove (traced
run only)."""


def read(ctx):
    vals = [j.prove_s - sum(j.stages.values()) for j in ctx.jobs if j.stages]
    if not vals:
        return None
    return 1e3 * sum(vals) / len(vals)
