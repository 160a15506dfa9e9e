"""Host Poseidon permutations a prove makes: the number of spans
"poseidon: permute_host" (one a permutation), mean over the traced
proves."""

import spans


def read(ctx):
    return spans.count_per_job(ctx, "poseidon: permute_host")
