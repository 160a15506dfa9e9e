"""The Merkle trees' share of their roofline: trees.bound (the
configuration's frozen shapes, hashed by its profile's hasher) over the
device-busy time inside the ranges "merkle: <tree>", in %."""

import trees


def read(ctx):
    busy = trees.busy_s(ctx)
    if not busy:
        return None
    least, _by = trees.bound(ctx.cell.size, ctx.cell.config["profile"])
    return 100.0 * least * len(ctx.jobs) / busy
