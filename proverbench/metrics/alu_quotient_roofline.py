"""The u32 ALU chips' quotients' share of their roofline:
roofline.quotient_bound of the configuration's frozen shapes and counts,
restricted to the u32 ALU chips, over the device-busy time inside the
ranges "quotient: <u32 ALU chip>", in %."""

import alu
import roofline


def read(ctx):
    busy = alu.busy_s(ctx, "quotient: ")
    if not busy:
        return None
    chips = {k: v for k, v in ctx.cell.size["chips"].items()
             if k in alu.CHIPS}
    least, _by = roofline.quotient_bound({"chips": chips})
    return 100.0 * least * len(ctx.jobs) / busy
