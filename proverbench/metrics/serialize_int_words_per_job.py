"""The integers a job's proof serialization writes one at a time as Python
ints: the port's counter `tooling/serde.py::stats` (every int its CBOR
encoder wrote alone, outside the uint32 arrays the native writer takes
whole) over the serializations it counted, one a job, over every job the
process ran.  None where the port has no such counter or serialized
nothing."""

import sys


def read(ctx):
    serde = sys.modules.get("valida_tpu_torch.tooling.serde")
    stats = getattr(serde, "stats", None)
    if not stats or not stats.get("serializations"):
        return None
    return stats["int_words"] / stats["serializations"]
