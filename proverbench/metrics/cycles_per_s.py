"""VM cycles executed by every job of the window (the CPU chip's clock, not
padded rows), over the whole window."""


def read(ctx):
    if not ctx.jobs:
        return None
    return sum(j.cycles for j in ctx.jobs) / ctx.window_s
