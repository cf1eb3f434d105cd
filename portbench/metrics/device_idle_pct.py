"""Device idle share of the profiled requests: 100 x (1 - the union of
device activity intervals / the traced window)."""

from portbench.metrics import spans


def read(ctx):
    return spans.idle_pct(ctx)
