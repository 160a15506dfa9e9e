"""The u32 ALU chips' trace builders on the host: milliseconds a prove
spends in the spans "trace inputs: <u32 ALU chip>" (each chip's
`device_trace_inputs`), mean over the traced proves."""

import alu
import spans


def read(ctx):
    ms = [spans.ms_per_job(ctx, f"trace inputs: {chip}")
          for chip in alu.CHIPS]
    ms = [v for v in ms if v is not None]
    return sum(ms) if ms else None
