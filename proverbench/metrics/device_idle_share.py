"""The device's idle share of the traced window: 1 - the union of its
operations' intervals (kernels, copies, memsets) over the window, in %."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
