"""How far one Sync result moves with the RANSAC seed alone, in the port
and in rssync_tpu, on the tracks of tests/test_pipeline.py's clip (the
reason test_torch_pipeline.py::test_sequential_matches_batched compares
means over seeds). On the CPU, from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_seed_spread.py [n_seeds]

Renders the clip with rssync_tpu's make_clip, tracks it once with the
port (its run_recipe fills a track cache), then for each seed feeds the
same gyro log and tracks to each engine and runs the sequential control
flow per syncpoint (pre_sync, then 4 x sync). Prints each window's
mean, std and range of the delay error over the seeds for both engines,
and the port's seed-0 batched and sequential run_recipe delays (with
debug.csv, as the test's recipe has it). Takes a few minutes.
"""

from __future__ import annotations

import glob
import os
import sys
import tempfile


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np
    import torch

    import jax

    jax.config.update("jax_platforms", "cpu")
    import rssync_tpu
    from rssync_tpu.pipeline.recipe import fill_gyro as jfill
    from rssync_tpu.testing.synthvideo import make_clip
    from rssync_tpu.utils import track_cache as jcache
    from rssync_tpu_torch import create_sync_problem
    from rssync_tpu_torch.pipeline import recipe as R
    from rssync_tpu_torch.utils import track_cache

    torch.set_num_threads(2)
    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    tmp = tempfile.mkdtemp(prefix="seed_spread_")
    clip = make_clip(tmp, seed=2, true_delay=0.0213, n_frames=26, fps=30.0, width=640,
                     height=480, pad=1.0)
    recipe = {
        "input": {
            "video_path": clip.video_path, "gyro_path": clip.gyro_path,
            "gyro_orientation": clip.orient, "frame_range": [0, 25],
            "lens_profile": {"path": clip.lens_path, "name": clip.lens_name},
            "initial_guess": 500.0, "use_simple_presync": True,
            "simple_presync_radius": 80.0, "simple_presync_step": 2.0,
        },
        "params": {"sync_window": 8, "syncpoints_format": "auto", "syncpoint_distance": 8},
        "output": {"csv_path": os.path.join(tmp, "sync.csv"),
                   "debug_csv_path": os.path.join(tmp, "debug.csv")},
    }
    cache = os.path.join(tmp, "cache")
    runs = {b: R.run_recipe(recipe, batched=b, seed=0, track_cache_dir=cache, device="cpu")
            for b in (True, False)}
    seq0, bat0 = np.asarray(runs[False].delays_ms), np.asarray(runs[True].delays_ms)
    print(f"port, seed 0, with debug.csv: batched {bat0.round(4).tolist()} ms, sequential "
          f"{seq0.round(4).tolist()} ms, |difference| {np.abs(seq0 - bat0).round(4).tolist()} ms",
          flush=True)
    tracks = glob.glob(os.path.join(cache, "*.npz"))[0]
    engines = {
        "port": (lambda s: create_sync_problem(s, device="cpu"), R.fill_gyro,
                 track_cache.load_tracks),
        "rssync_tpu": (lambda s: rssync_tpu.create_sync_problem(seed=s), jfill,
                       jcache.load_tracks),
    }
    for name, (make, fill, load) in engines.items():
        err = {p: [] for p in (0, 8, 16)}
        for seed in range(n_seeds):
            sp = make(seed)
            fill(sp, clip.gyro_path, clip.orient)
            load(sp, tracks)
            for pos in err:
                _, d = sp.pre_sync(0.5, pos, pos + 8, 0.002, 0.08)
                for _ in range(4):
                    _, d = sp.sync(d, pos, pos + 8, 0.5, 0.08)
                err[pos].append(1000.0 * (d - clip.true_delay))
        for pos, v in err.items():
            v = np.asarray(v)
            print(f"{name} window {pos}: {n_seeds} seeds, error mean {v.mean():.4f} ms, std "
                  f"{v.std():.4f}, min {v.min():.4f}, max {v.max():.4f}, range "
                  f"{v.max() - v.min():.4f} ms", flush=True)


if __name__ == "__main__":
    main()
