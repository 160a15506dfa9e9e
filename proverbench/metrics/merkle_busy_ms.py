"""The Merkle trees: device-busy milliseconds inside the ranges "merkle:
<tree>" (the leaf and compression replays of the four commits' trees and
of every FRI layer's, all but each tree's root level), mean per prove."""

import trees


def read(ctx):
    busy = trees.busy_s(ctx)
    return None if busy is None else 1e3 * busy / len(ctx.jobs)
