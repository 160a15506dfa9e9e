"""The proof-of-work grind's candidates a prove: the port's counter
`commit/fri.py::grind_stats` (every candidate of every batch it permuted)
over the grinds it counted, one a prove, over every prove of the process
(set-up's warm-up and the window's).  None where the port has no such
counter."""

import sys


def read(ctx):
    fri = sys.modules.get("valida_tpu_torch.commit.fri")
    stats = getattr(fri, "grind_stats", None)
    if not stats or not stats.get("grinds"):
        return None
    return stats["candidates"] / stats["grinds"]
