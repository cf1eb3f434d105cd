"""The device trace of a traced run: a few whole requests run under
torch.profiler (device activity only) after the measured window, each
harness span ending on a device synchronize. What the per-layer readers
read: device intervals by name, the harness spans on the trace's clock
(the wall clock), the device's busy time over the traced window, and
the breakdown the result line carries: the device operations that took
most time, and the device's idle seconds summed by the span the host
was in."""

from __future__ import annotations

import bisect
import sys
import time
from dataclasses import dataclass

import torch
from torch.profiler import ProfilerActivity, profile

from portbench.metrics import arith

#: entries of each breakdown list
TOP = 10


@dataclass
class Trace:
    #: (name, start s, end s) of every device activity, from the first
    #: span's start on the wall clock
    device: list
    #: (span name, request, start s, end s) of every harness span, the same
    spans: list
    t0: float
    t1: float
    #: the profiled requests
    requests: list

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return arith.union_s(self.clipped(self.device))

    def clipped(self, events) -> list:
        return [(max(s, self.t0), min(e, self.t1)) for _, s, e in events
                if e > self.t0 and s < self.t1]

    def kernel_s(self, names, within: str | None = None) -> float | None:
        """Device seconds of the activities whose name contains one of
        `names` (only those inside a `within` span, when given); None
        when no such activity ran."""
        ranges = [(s, e) for n, _, s, e in self.spans if n == within] if within else None
        total, seen = 0.0, False
        for name, s, e in self.device:
            if not any(k in name for k in names):
                continue
            if ranges is not None and not any(a <= s and e <= b for a, b in ranges):
                continue
            total += e - s
            seen = True
        return total if seen else None

    def breakdown(self) -> dict:
        by_name: dict[str, float] = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        # idle seconds by the span the host was in when each gap began
        # (the harness's spans of one request do not overlap)
        spans = sorted(self.spans, key=lambda sp: sp[2])
        starts = [sp[2] for sp in spans]
        idle: dict[str, float] = {}
        for a, b in arith.idle_gaps(self.clipped(self.device), self.t0, self.t1):
            i = bisect.bisect_right(starts, a) - 1
            name = spans[i][0] if i >= 0 and a < spans[i][3] else "between spans"
            idle[name] = idle.get(name, 0.0) + (b - a)
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def profile_requests(driver, requests: list, n: int, on_card: bool) -> Trace:
    """Run `n` more requests under the profiler and append them to
    `requests` (marked `profiled`); their spans end on a synchronize."""
    from portbench.harness import Request, Spans

    spans = Spans(sync=on_card)
    acts = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(n):
            req = Request(index=len(requests), windows=driver.next_windows(), profiled=True)
            driver.run(req, spans)
            requests.append(req)
    t = time.perf_counter()
    # seconds from the first span's start: ns since the epoch would lose
    # sub-microsecond digits as float seconds
    base = min(sp.wall_start for sp in spans.records)
    cuda = torch.autograd.DeviceType.CUDA
    device = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or getattr(e, "is_user_annotation", lambda: False)():
            continue
        device.append((e.name(), (e.start_ns() - base) * 1e-9, (e.end_ns() - base) * 1e-9))
    ranges = [(sp.name, sp.request, (sp.wall_start - base) * 1e-9, (sp.wall_end - base) * 1e-9)
              for sp in spans.records]
    print(f"# trace: {len(device)} device activities read in {time.perf_counter() - t:.1f} s",
          file=sys.stderr, flush=True)
    return Trace(device=device, spans=ranges, t0=0.0, t1=max(r[3] for r in ranges),
                 requests=requests[len(requests) - n:])
