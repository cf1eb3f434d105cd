"""Stage timings, and the program's span and counter recorder.

The reference's observability is bare stderr progress lines (per-frame
tracking core_testcode.cpp:117, per-iteration Sync trace
core_private.cpp:330). `Timings` adds a registry of named stages,
queryable and printable as a report. A copy of the host part of
rssync_tpu/utils/timing.py; a stage timed around work on the card
measures it only if the work is synchronized inside the stage.

`span` and `count` mark the program's inner boundaries (the tracker's
block steps, the Sync loop's iterations) for the `Recorder` that
`recording()` turns on. Recording is off by default: `span` then
returns one shared no-op and `count` returns at once, so a span costs a
function call and an empty `with`. Spans are stamped with
`time.time_ns()`, the clock torch.profiler places its device trace on,
and never synchronize the device: a span times the host, and a wait for
the card shows up in the span around the host read that already waits.
The stack of open spans is kept per thread, so spans opened on worker
threads (parallel/mesh.py) are roots of their own trees.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
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
    """Collects wall-clock per named stage; nestable. Each stage is also
    a `span`, so a recording holds the stages as the roots of its
    trees."""

    stages: dict = field(default_factory=lambda: defaultdict(StageStats))

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
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


# ---------------------------------------------------------------------------
# spans and counts


@dataclass(slots=True)
class SpanRecord:
    name: str
    id: int
    #: id of the span open around this one in its thread, None at a root
    parent: int | None
    #: the recorder's `context` when the span opened
    context: object
    #: time.time_ns() at enter and at exit
    start_ns: int
    end_ns: int = 0
    #: counts added while this was the innermost open span
    counts: dict = field(default_factory=dict)


class Recorder:
    """The spans of one recording, in memory, in the order they closed."""

    def __init__(self, context=None):
        #: stamped on every span opened from now on (a request's index)
        self.context = context
        self.records: list[SpanRecord] = []
        #: counts added while no span was open
        self.counts: dict = {}
        self._ids = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def counted(self, name: str) -> int:
        """Count `name` summed over the whole recording."""
        return self.counts.get(name, 0) + sum(r.counts.get(name, 0) for r in self.records)

    def summary(self) -> dict:
        """{span name: {"calls", "total_s", "self_s", "counts"}}. A span's
        self time is its time less that of the spans opened directly
        inside it; counts are summed by name."""
        child_ns: dict[int, int] = defaultdict(int)
        for r in self.records:
            if r.parent is not None:
                child_ns[r.parent] += r.end_ns - r.start_ns
        out: dict[str, dict] = {}
        for r in self.records:
            s = out.setdefault(r.name, {"calls": 0, "total_s": 0.0, "self_s": 0.0, "counts": {}})
            dt = r.end_ns - r.start_ns
            s["calls"] += 1
            s["total_s"] += dt * 1e-9
            s["self_s"] += (dt - child_ns[r.id]) * 1e-9
            for k, v in r.counts.items():
                s["counts"][k] = s["counts"].get(k, 0) + v
        return out


class _Span:
    __slots__ = ("_rec", "_name", "_record")

    def __init__(self, rec: Recorder, name: str):
        self._rec, self._name = rec, name

    def __enter__(self) -> None:
        rec = self._rec
        stack = rec._stack()
        self._record = SpanRecord(self._name, next(rec._ids), stack[-1].id if stack else None,
                                  rec.context, time.time_ns())
        stack.append(self._record)

    def __exit__(self, *exc) -> bool:
        r = self._record
        r.end_ns = time.time_ns()
        self._rec._stack().pop()
        self._rec.records.append(r)
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


#: what `span` returns while nothing records
NO_SPAN = _NoSpan()
#: the recorder of the `recording()` open now, None when none is
_active: Recorder | None = None


def span(name: str):
    """A context manager that records a span called `name` (a constant
    string) while a `recording()` is open, and does nothing otherwise."""
    rec = _active
    if rec is None:
        return NO_SPAN
    return _Span(rec, name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to count `name` of the innermost open span of this thread
    (of the recorder, with none open) while a `recording()` is open."""
    rec = _active
    if rec is None:
        return
    stack = rec._stack()
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n
        return
    with rec._lock:  # threads share the recorder's own counts
        rec.counts[name] = rec.counts.get(name, 0) + n


@contextlib.contextmanager
def recording(context=None):
    """Record every span and count of the process, from every thread,
    until the block ends; yields the `Recorder`. The recording open
    before it, if any, resumes after."""
    global _active
    rec, prev = Recorder(context), _active
    _active = rec
    try:
        yield rec
    finally:
        _active = prev
