"""The Python work after the native core: milliseconds a job spends in
the span "execute: range checks" (`BasicMachine.run_native`: the memory
and output chips' range-check registrations), mean over the traced
jobs."""

import spans


def read(ctx):
    return spans.ms_per_job(ctx, "execute: range checks")
