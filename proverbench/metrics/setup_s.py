"""Seconds from the process's start to the window's: imports, the build
or load of the port's libraries, one execution and `warmup_jit`."""


def read(ctx):
    return ctx.setup_s
