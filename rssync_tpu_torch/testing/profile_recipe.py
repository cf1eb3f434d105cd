"""Profile the recipe path's host side on a CUDA card: video decode and
the stages of run_recipe at chip_smoke.py's phase-16 operating point.

    python -m rssync_tpu_torch.testing.profile_recipe

Renders phase 8's clip on the card (2704x2028, 60 fps, 480 frames),
writes it with `write_clip_files` (mp4 through cv2's mp4v writer, .gcsv,
lens file) and prints, each once:

- the mp4 write seconds;
- a decoder process's start: 4 spawned processes that run
  frontend/decode_pool.py's file (the port's workers) against 4 that
  import the package (what a worker that unpickles a function of the
  package pays: torch's import), start to exit;
- the recipe's decode ranges (the 4 windows, 248 frames) decoded by
  one `VideoSource` in order, by `FrameFeed` per range, and by
  `DecodePool` with 1, 2 and 4 workers (its first frame and all);
- `run_recipe` under `utils/timing.recording()`: its Timings and the
  recording's summary (calls, total and self seconds and counts of each
  span: the stages, the tracking stage's `track.decode_wait`,
  `track.stack`, `track.upload`, the tracker's and emission's spans, the
  Sync loop's), then the same recipe again from its track cache.

The last line is all of it as one JSON object. Spawned decoders re-run
the main module; this one imports nothing but the standard library at
its top, and it hides its module name from spawn (see the end), so they
do not import the package.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time


def _first_and_all(it) -> tuple[float, float]:
    t0 = time.perf_counter()
    first = None
    for _ in it:
        if first is None:
            first = time.perf_counter() - t0
    return first, time.perf_counter() - t0


def _process_start(target, args, n: int = 4) -> float:
    """Seconds for n spawned processes running target(*args) to start
    and exit, all started together."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=target, args=args) for _ in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    return time.perf_counter() - t0


def main() -> None:
    import importlib
    import runpy

    import torch

    from rssync_tpu_torch.frontend import decode_pool as DP
    from rssync_tpu_torch.frontend import tracking as TR
    from rssync_tpu_torch.pipeline import recipe as RC
    from rssync_tpu_torch.testing.synthvideo import make_clip, write_clip_files
    from rssync_tpu_torch.utils.timing import recording

    if not torch.cuda.is_available():
        sys.exit("profile_recipe: needs a CUDA card")
    out = {"card": torch.cuda.get_device_name(0)}
    clip = make_clip(seed=0, true_delay=0.0423, fps=60.0, n_frames=480, width=2704,
                     height=2028, gyro_rate=200.0, readout=0.01111, pad=2.0)
    tmp = tempfile.mkdtemp(prefix="rssync_profile_recipe_")
    t0 = time.perf_counter()
    files = write_clip_files(clip, tmp)
    out["write_mp4_s"] = time.perf_counter() - t0
    out["start_4_file_workers_s"] = _process_start(runpy.run_path, (DP.__file__,))
    out["start_4_package_workers_s"] = _process_start(importlib.import_module,
                                                      ("rssync_tpu_torch",))

    recipe = {
        "input": {
            "video_path": files.video_path, "gyro_path": files.gyro_path,
            "gyro_orientation": clip.orient, "frame_range": [0, clip.n_frames - 1],
            "lens_profile": {"path": files.lens_path, "name": files.lens_name},
            "initial_guess": 1000.0, "use_simple_presync": True,
            "simple_presync_radius": 200.0, "simple_presync_step": 2.0,
        },
        "params": {"sync_window": 60, "syncpoint_distance": 120},
        "output": {"csv_path": os.path.join(tmp, "sync.csv"),
                   "debug_csv_path": os.path.join(tmp, "debug.csv")},
    }
    ranges = TR._merge_pair_ranges(RC._window_pair_ranges(recipe), 0, clip.n_frames - 1)
    spans = [(b, e + 1) for b, e in ranges]
    out["frames"] = sum(e - b for b, e in spans)
    src = TR.VideoSource(files.video_path)
    t0 = time.perf_counter()
    for b, e in spans:
        for _ in src.frames(b, e):
            pass
    out["serial_decode_s"] = time.perf_counter() - t0
    src.close()
    t0 = time.perf_counter()
    for b, e in spans:
        for _ in TR.FrameFeed(files.video_path, b, e):
            pass
    out["frame_feed_s"] = time.perf_counter() - t0
    for n in (1, 2, 4):
        with DP.DecodePool(files.video_path, spans, clip.height, clip.width, src._raw, n) as pool:
            first, total = _first_and_all(
                x for i in range(len(spans)) for x in pool.span_frames(i))
        out[f"pool_{n}_first_frame_s"], out[f"pool_{n}_s"] = first, total
    for k, v in out.items():
        print(f"# {k}: {v}", flush=True)

    for run in ("computed", "cache_hit"):
        timings = RC.Timings()
        t0 = time.perf_counter()
        with recording() as rec:
            RC.run_recipe(recipe, timings=timings, track_cache_dir=os.path.join(tmp, "cache"))
        out[f"run_recipe_{run}_s"] = time.perf_counter() - t0
        out[f"stages_{run}"] = timings.as_dict()
        out[f"spans_{run}"] = rec.summary()
        print(f"# run_recipe ({run}): {out[f'run_recipe_{run}_s']:.3f} s", flush=True)
        print(timings.report(), flush=True)
        for name, s in sorted(out[f"spans_{run}"].items(), key=lambda kv: -kv[1]["total_s"]):
            print(f"# span {name}: {s['calls']} calls, {s['total_s']:.4f} s, self "
                  f"{s['self_s']:.4f} s, counts {s['counts']}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    # run with -m, spawn would import this module by name in every
    # decoder, and with it the package and torch; by file it re-runs
    # only the standard-library imports above
    sys.modules["__main__"].__spec__ = None
    main()
