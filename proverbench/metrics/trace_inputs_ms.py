"""The trace builders' host work: milliseconds a prove spends in the
spans "trace inputs: <chip>" (each chip's `device_trace_inputs` or
`generate_trace`, inside the stage "generate main traces"), mean over the
traced proves."""

import spans


def read(ctx):
    return spans.ms_per_job(ctx, "trace inputs: ", prefix=True)
