"""The control's readings that the limits of `correct` are set beside.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3

For each seed, the control: the plain reference put in the program's
place and computed in bfloat16, the precision below the float32 the
configurations state (its tracks, its rays and its delays), judged by
the same comparison as the program's answers, over every window of the
cell. Prints one JSON line per seed. The program's own readings are the
`checks` of its runs (`portbench.run`).

The reference is the truth of the scene the cell's configuration names
(the key `model` of its `scene` section: `reference/<model>.py` under
the cell's checkout; without the key, `reference/truth.py`), found by
`harness.scene_truth` as the program's runs find it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from portbench import harness


def control_requests(cell: harness.Cell, clip: harness.Clip,
                     dtype=torch.bfloat16) -> list[harness.Request]:
    """The reference's answers in `dtype`, shaped as the program's: every
    window once, in requests of the mix's size."""
    cfg = cell.config
    ref = harness.scene_truth(cfg, cell.root)
    window = int(cfg["recipe"]["sync_window"])
    lens = vars(clip.lens)
    grid = ref.grid_points(clip.width, clip.height, int(cfg["tracker"]["grid_step"]))
    n_w = len(clip.syncpoints)
    frames_a = (clip.syncpoints[:, None] + np.arange(window + 1)[None]).reshape(-1)
    q = ref.true_tracks(clip.trajectory, lens, grid, frames_a, clip.fps, clip.height, dtype)
    rays = ref.undistort_ray(lens, q).reshape(n_w, window + 1, len(grid), 3)
    delays = ref.window_delays(clip.syncpoints, clip.fps, window, clip.engine_delay,
                               clip.drift, dtype)
    per = n_w if cell.mix["windows_per_request"] == "all" else int(cell.mix["windows_per_request"])
    reqs = []
    for s in range(0, n_w, per):
        ws = list(range(s, min(s + per, n_w)))
        d = [float(delays[w]) for w in ws]
        tracks = [(window + 1, np.full(window + 1, len(grid)), rays[w].permute(2, 0, 1).double())
                  for w in ws]
        reqs.append(harness.Request(index=len(reqs), windows=ws, presync=d, final=d,
                                    tracks=tracks))
    return reqs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        clip = harness.make_clip(cell.config, seed, "cpu", render=False, root=cell.root)
        numbers = harness.compare(cell, clip, control_requests(cell, clip))
        ok, checks = harness.judge(numbers, cell.limits)
        print(json.dumps({"side": "control", "workload": args.workload, "seed": seed,
                          "correct": ok, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
