"""The native interpreter: milliseconds a job spends building its machine
and in `run_native(build_lists=False)` (the harness's clock), mean over the
window's jobs."""


def read(ctx):
    if not ctx.jobs:
        return None
    return 1e3 * sum(j.execute_s for j in ctx.jobs) / len(ctx.jobs)
