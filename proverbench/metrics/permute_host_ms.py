"""The host challenger's permutations: milliseconds a prove spends in the
span "poseidon: permute_host" (one a permutation), mean over the traced
proves."""

import spans


def read(ctx):
    return spans.ms_per_job(ctx, "poseidon: permute_host")
