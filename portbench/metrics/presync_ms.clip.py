"""PreSync: milliseconds of the `presync` span (the batched PreSync over
every window and the delay grid) per clip."""

from portbench.metrics import spans


def read(ctx):
    return spans.ms_per_request(ctx, "presync")
