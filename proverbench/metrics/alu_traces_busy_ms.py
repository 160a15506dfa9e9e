"""The u32 ALU chips' trace builders on the card: device-busy
milliseconds inside the ranges "main trace: <u32 ALU chip>" (the replay
of each chip's trace stage inside "generate main traces"; its uploads
and the copies into the graph's inputs are not in it), mean per prove."""

import alu


def read(ctx):
    busy = alu.busy_s(ctx, "main trace: ")
    return None if busy is None else 1e3 * busy / len(ctx.jobs)
