"""Readings of the program's own spans and counts (rssync_tpu_torch/
utils/timing.py), from the recorders that `requests/batched_recorded.py`
keeps on each request of a traced run's measured window. A program
without a span or count reads as nothing, so a reader returns None
there."""

from __future__ import annotations


def recorders(ctx) -> list:
    """The recorders of the window's completed requests."""
    return [r.recorder for r in ctx.window_requests() if getattr(r, "recorder", None)]


def span_s(recs, name: str) -> float | None:
    """Seconds inside the spans called `name` (children included),
    summed over `recs`; None when no such span was recorded."""
    secs = [(s.end_ns - s.start_ns) * 1e-9 for rec in recs for s in rec.records
            if s.name == name]
    return sum(secs) if secs else None


def counted(recs, name: str) -> int | None:
    """Count `name` summed over `recs`; None when nothing counted it."""
    seen = [rec for rec in recs
            if name in rec.counts or any(name in s.counts for s in rec.records)]
    return sum(rec.counted(name) for rec in seen) if seen else None
