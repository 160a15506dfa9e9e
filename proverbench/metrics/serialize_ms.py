"""Proof serialization: milliseconds a job spends in the spans
"serialize: to object" (`serde.proof_to_obj`) and "serialize: cbor"
(`serde.cbor_dumps`), mean over the traced jobs."""

import spans


def read(ctx):
    return spans.ms_per_job(ctx, "serialize: ", prefix=True)
