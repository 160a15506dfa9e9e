"""The u32 ALU chips' quotients: device-busy milliseconds inside the
ranges "quotient: <u32 ALU chip>" (each chip's quotient replay inside
"compute quotient polynomial"), mean per prove."""

import alu


def read(ctx):
    busy = alu.busy_s(ctx, "quotient: ")
    return None if busy is None else 1e3 * busy / len(ctx.jobs)
