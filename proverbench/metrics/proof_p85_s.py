"""The 85th percentile (nearest rank) over all jobs of the window of each
job's time from the start of its execution to its proof's bytes: the
highest round percentile with ten jobs or more beyond it at the 85-100
jobs a window of fibonacci.short10 finishes."""

import math


def read(ctx):
    if not ctx.jobs:
        return None
    times = sorted(j.total_s for j in ctx.jobs)
    return times[math.ceil(0.85 * len(times)) - 1]
