"""Sync(4x): milliseconds of the `sync4x` span (4 batched Sync passes
over every window, ending on the host read of the delays) per clip."""

from portbench.metrics import spans


def read(ctx):
    return spans.ms_per_request(ctx, "sync4x")
