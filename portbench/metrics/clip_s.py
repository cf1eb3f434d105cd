"""clip_s: seconds of the measured window (the client's time inside its
requests) over the clips completed in it."""

from portbench.metrics import arith


def read(ctx):
    return arith.per_request(ctx.window_s, len(ctx.window_requests()))
