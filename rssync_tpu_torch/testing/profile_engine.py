"""Profile the engine's two stages on a CUDA card.

    python -m rssync_tpu_torch.testing.profile_engine

Builds the engine's reference operating point (60 s at 60 fps, 130
features, 30 windows of 60 frames, PreSync over +-200 ms in 2 ms steps,
4 Sync passes), runs each stage once to warm up and once under
torch.profiler. For each stage it prints, from that one profiled call:
the host wall time, the device busy time (the union of the device
activity intervals in the same trace), the idle share 1 - busy / wall,
the number of device activities and the device time and count of the
kernels that took the most.
For PreSync also the delay chunk and the peak device bytes per
(delay, window, frame, feature) element (from the warm-up call, which
runs without the profiler); for Sync the outer iterations of each pass.
The last line is all of it as one JSON object.
"""

from __future__ import annotations

import json
import math
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from rssync_tpu_torch import create_sync_problem
from rssync_tpu_torch.core.presync import BYTES_PER_ELEMENT, delay_chunk, presync_grid
from rssync_tpu_torch.ops import score as S
from rssync_tpu_torch.pipeline.recipe import presync_stage, sync_stage, syncpoint_windows
from rssync_tpu_torch.testing.engine_problem import (
    OPERATING_POINT,
    PRESYNC_RADIUS_MS,
    PRESYNC_STEP_MS,
    make_engine_problem,
)

TOP_KERNELS = 8


def _union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    busy, reach = 0.0, -math.inf
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def profile_call(fn):
    """Run fn once under the profiler; (fn's result, measurements)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    busy = _union_us(spans) / 1e6
    by_name: dict[str, list] = {}
    for e in device:
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += (e.time_range.end - e.time_range.start) / 1e3
        row[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    return out, dict(
        wall_s=wall, device_busy_s=busy, idle_share=1.0 - busy / wall,
        device_activities=len(device),
        top=[dict(ms=ms, count=n, name=name[:200]) for name, (ms, n) in top],
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_engine: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    prob = make_engine_problem(**OPERATING_POINT)
    sp = create_sync_problem(seed=0, device=dev)
    prob.feed(sp)
    open_wins, closed_wins = syncpoint_windows(sp, prob.syncpoints, prob.sync_window)
    W, F = open_wins.counts.shape
    N = open_wins.num_features
    D = len(presync_grid(0.0, PRESYNC_RADIUS_MS / 1000, PRESYNC_STEP_MS / 1000))
    K = delay_chunk(dev, D, W * F * N)

    def presync():
        return presync_stage(sp, open_wins, 0.0, PRESYNC_RADIUS_MS, PRESYNC_STEP_MS)

    def sync4(delays):
        return sync_stage(sp, closed_wins, delays, 0.0, PRESYNC_RADIUS_MS / 1000)

    # warm-up, and the peak bytes of a PreSync chunk
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    best = presync()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    sync4(best)

    report = dict(device=torch.cuda.get_device_name(0), windows=W, frames=F,
                  features=N, delays=D)
    S.reset_launch_counters()
    best, report["presync"] = profile_call(presync)
    report["presync"].update(
        delay_chunk=K, peak_bytes=peak, bytes_per_element=peak / (K * W * F * N),
        bytes_per_element_budget=BYTES_PER_ELEMENT,
        score_launches=dict(S.LAUNCHES),
    )
    S.reset_launch_counters()
    results, report["sync4x"] = profile_call(lambda: sync4(best))
    report["sync4x"].update(
        outer_iterations=[int(r.iterations.max()) for r in results],
        score_launches=dict(S.LAUNCHES),
    )
    err = (results[-1].delay.double() - prob.true_delay).abs().max().item() * 1e3
    report["max_offset_err_ms"] = err

    for stage in ("presync", "sync4x"):
        r = report[stage]
        print(f"== {stage}: wall {r['wall_s'] * 1e3:.2f} ms, device busy "
              f"{r['device_busy_s'] * 1e3:.2f} ms, idle share {r['idle_share']:.3f}, "
              f"{r['device_activities']} device activities")
        for k in r["top"]:
            print(f"   {k['ms']:10.3f} ms {k['count']:6d} x  {k['name']}")
    print(f"presync: delay chunk {K} of {D}, peak {peak / 2**30:.3f} GiB, "
          f"{report['presync']['bytes_per_element']:.1f} B per element "
          f"(budget {BYTES_PER_ELEMENT})")
    print(f"sync4x: outer iterations per pass {report['sync4x']['outer_iterations']}; "
          f"max offset error {err:.4f} ms")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
