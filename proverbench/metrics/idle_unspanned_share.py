"""The device's idle time that no program range names: the idle seconds
of the traced window whose innermost host range is one of the harness's
own "job: ..." ranges or none at all, over all its idle seconds, in %
(trace.Trace.breakdown, every name)."""

import trace


def read(ctx):
    if ctx.trace is None:
        return None
    idle = dict(ctx.trace.breakdown(top=None)["idle_gaps"])
    total = sum(idle.values())
    if total <= 0:
        return None
    unnamed = sum(v for k, v in idle.items()
                  if k == trace.OUTSIDE or k.startswith("job: "))
    return 100.0 * unnamed / total
