"""Tracking: milliseconds of the `track` span (track_clip: pyramid,
coarse init, LK levels, emission into the problem) per frame pair."""

from portbench.metrics import spans


def read(ctx):
    return spans.ms_per_pair(ctx, "track")
