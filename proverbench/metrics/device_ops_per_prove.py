"""Device operations (kernels, copies, memsets) in the traced window, per
prove."""


def read(ctx):
    if ctx.trace is None or not ctx.jobs or not ctx.trace.ops:
        return None
    return len(ctx.trace.ops) / len(ctx.jobs)
