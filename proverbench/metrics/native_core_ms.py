"""The native interpreter's C++ core: milliseconds a job spends in the
span "execute: native core" (`native.run_native`, from the VM's creation
through its run), mean over the traced jobs."""

import spans


def read(ctx):
    return spans.ms_per_job(ctx, "execute: native core")
