"""Profile the tracker on a CUDA card at its operating point.

    python -m rssync_tpu_torch.testing.profile_tracker

One 16-pair chunk of 2704x2028 noise frames (stored 2816x2056, made on
the card) on the 130-point step-200 grid, the unit
`lk_track_video_chunked` repeats. After a warm-up it prints:

- each stage of the chunk timed alone (host clock around synchronized
  calls, median of 5): the sparse pyramid of the 17 frames, the coarse
  init, the level-2 and the level-0 LK steps, each of those split into
  templates and search (the search includes the strip fetch);
- one call of the whole chunk under torch.profiler: host wall, device
  busy (the union of the device intervals), idle share 1 - busy / wall,
  the device activities, and the device time and count of the kernels
  that took the most.

The last line is all of it as one JSON object.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import torch

from rssync_tpu_torch.frontend import tracking as TR
from rssync_tpu_torch.testing.profile_engine import profile_call

H, W = 2028, 2704
GRID_STEP = 200
CHUNK = 16


def _median_s(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_tracker: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    levels = TR.auto_levels(H, W)
    Hp, Wp = TR._stored_dims(H, W, "fine")
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randint(0, 256, (CHUNK + 1, Hp, Wp), dtype=torch.uint8, device=dev,
                           generator=gen)
    pts = TR.grid_points(W, H, GRID_STEP).astype("float32")
    need, plan, _ = TR._level_plan(levels, TR.LK_ITERS, TR.LK_RADIUS)
    fine = TR._fine_plan(levels, TR.LK_ITERS, TR.LK_RADIUS)
    entry = fine[0][0]
    lvl_glob = levels - 1
    lvl_vol = max(entry + 1, lvl_glob - 2)

    def chunk():
        return TR.lk_track_video(frames, grid_step=GRID_STEP, logical_hw=(H, W))

    # the chunk's stages, in _lk_video_core's and _lk_core's order
    pyr = TR.build_pyramid_sparse(frames, levels, need, (H, W), plan)
    pairs = {l: (pyr[l][:-1], pyr[l][1:]) for l in need}
    D_glob = max(2, min(pairs[lvl_glob][0].shape[-2:]) // 3)
    coarse = {l: pairs[l] for l in (lvl_vol, lvl_glob)}
    glob_hw = tuple(TR._lvl_size(n, 0, lvl_glob) for n in (H, W))  # the deep plan's
    d0 = TR._coarse_init(coarse, lvl_vol, lvl_glob, pts, D_glob, glob_hw)
    stages = {
        "pyramid": lambda: TR.build_pyramid_sparse(frames, levels, need, (H, W), plan),
        "coarse_init": lambda: TR._coarse_init(coarse, lvl_vol, lvl_glob, pts, D_glob, glob_hw),
    }
    d = d0
    for lvl, it, margin, radius in fine:
        scale = float(2**lvl)
        a, b = pairs[lvl]
        p, g = pts / scale, d / scale
        tmpl = TR._lk_templates(a, p, radius)
        stages[f"level{lvl}_templates"] = (
            lambda a=a, p=p, radius=radius: TR._lk_templates(a, p, radius))
        stages[f"level{lvl}_search"] = (
            lambda b=b, p=p, g=g, tmpl=tmpl, radius=radius, it=it, margin=margin:
            TR._lk_iterate(b, p, g, tmpl, radius, it, margin))
        d = TR._lk_iterate(b, p, g, tmpl, radius, it, margin) * scale

    report = dict(device=torch.cuda.get_device_name(0), frames=CHUNK + 1, stored=[Hp, Wp],
                  levels=levels, plan=fine, points=len(pts))
    report["chunk_s"] = _median_s(chunk)
    report["stages_s"] = {name: _median_s(fn) for name, fn in stages.items()}
    _, prof = profile_call(chunk)
    report["profile"] = prof
    print(f"chunk of {CHUNK} pairs: {report['chunk_s'] * 1e3:.3f} ms "
          f"({report['chunk_s'] * 1e3 / CHUNK:.4f} ms/pair)")
    for name, s in report["stages_s"].items():
        print(f"   {name:18s} {s * 1e3:9.3f} ms")
    print(f"== profiled chunk: wall {prof['wall_s'] * 1e3:.2f} ms, device busy "
          f"{prof['device_busy_s'] * 1e3:.2f} ms, idle share {prof['idle_share']:.3f}, "
          f"{prof['device_activities']} device activities")
    for k in prof["top"]:
        print(f"   {k['ms']:10.3f} ms {k['count']:6d} x  {k['name']}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
