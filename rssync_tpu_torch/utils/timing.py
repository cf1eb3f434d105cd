"""Structured per-stage wall-clock timing.

The reference's observability is bare stderr progress lines (per-frame
tracking core_testcode.cpp:117, per-iteration Sync trace
core_private.cpp:330). `Timings` adds a registry of named stages,
queryable and printable as a report. A copy of the host part of
rssync_tpu/utils/timing.py; a stage timed around work on the card
measures it only if the work is synchronized inside the stage.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.calls += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)


@dataclass
class Timings:
    """Collects wall-clock per named stage; nestable."""

    stages: dict = field(default_factory=lambda: defaultdict(StageStats))

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name].add(time.perf_counter() - t0)

    def report(self) -> str:
        lines = ["stage                         calls    total      mean"]
        for name, s in sorted(self.stages.items(), key=lambda kv: -kv[1].total_s):
            mean = s.total_s / max(s.calls, 1)
            lines.append(f"{name:<28} {s.calls:>6} {s.total_s:>8.3f}s {mean:>8.4f}s")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {k: {"calls": v.calls, "total_s": v.total_s} for k, v in self.stages.items()}
