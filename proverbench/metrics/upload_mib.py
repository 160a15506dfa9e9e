"""Host-to-device bytes a prove uploads (jit_prover.transfer_stats, an
exact count), mean per prove, in MiB."""


def read(ctx):
    if not ctx.jobs:
        return None
    return sum(j.upload_bytes for j in ctx.jobs) / len(ctx.jobs) / 2**20
