"""Gyro-orientation brute force: rank all 48 axis permutation/sign
variants by PreSync cost.

Rebuild of the reference's disabled `guess_orient` main
(ref: src/core_testcode.cpp:184-233, README.md:47-48): the reference
reloads the gyro and reruns PreSync 48 times sequentially; here the
telemetry loads once, all 48 variants integrate and fit on the host as
one batch, and the (variants x delay grid) volume evaluates as rows of
one batched PreSync: the orientation axis is one more batch axis. A
copy of rssync_tpu/pipeline/guess_orient.py on the port's engine and
tracker.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from rssync_tpu_torch.core.api import SyncProblem, resample_quats_us
from rssync_tpu_torch.core.presync import presync_grid
from rssync_tpu_torch.core.problem import SplineTable, TrackWindow, make_spline_tables_batched
from rssync_tpu_torch.frontend.integrate import integrate_gyro
from rssync_tpu_torch.frontend.lens_profiles import load_lens_profile
from rssync_tpu_torch.frontend.telemetry import apply_orientation, load_gyro
from rssync_tpu_torch.parallel.batch import presync_costs
from rssync_tpu_torch.pipeline.recipe import _load_recipe, gyro_timestamps_us


def all_orientations() -> list[str]:
    """All 48 = 3! axis permutations x 2^3 sign patterns."""
    return [
        "".join(c.upper() if up else c for c, up in zip(perm, signs))
        for perm in itertools.permutations("xyz")
        for signs in itertools.product((False, True), repeat=3)
    ]


def _variant_costs(tables: SplineTable, win: TrackWindow, delays: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """costs (V, D): the PreSync cost of the one window against each of
    the V stacked tables at every delay, the (delay x variant) rows
    going through one batched scoring path."""
    V, D = tables.coeffs.shape[0], delays.shape[0]
    wins = win.map(lambda x: x.expand(V, *x.shape))
    costs, _ = presync_costs(tables, wins, delays, generator)
    return costs[:D].T


def run_guess_orient(recipe, frames: tuple[int, int] | None = None, method: str = "lk",
                     seed: int = 0, progress: bool = False,
                     device="cuda") -> list[tuple[float, float, str]]:
    """Returns [(min_cost, argmin_delay_s, orient)] sorted by cost
    ascending (the reference prints the top 5, ref :227-231)."""
    from rssync_tpu_torch.frontend.tracking import track_frames

    recipe = _load_recipe(recipe)
    inp = recipe["input"]
    frame_begin, frame_end = frames or (int(v) for v in inp["frame_range"])
    sp = SyncProblem(seed=seed, device=device)  # refuses a missing card first

    data = load_gyro(inp["gyro_path"], orient=None)
    variants = all_orientations()
    if progress:
        print(f"testing {len(variants)} orientation variants...", flush=True)
    # integrate, resample and fit all 48 variants as one host batch: the
    # timestamps are shared, so the resample grid, the SLERP brackets
    # and the spline solve run once over a (48, n) batch
    ts_us = gyro_timestamps_us(data.timestamps)
    oriented = np.stack([apply_orientation(data.gyro, v) for v in variants])  # (V, n, 3)
    quats = integrate_gyro(data.timestamps, oriented)  # (V, n, 4)
    rate_hz, _, new_q = resample_quats_us(ts_us, quats)
    tables = make_spline_tables_batched(new_q, float(rate_hz), device=sp.device)
    # any variant serves the window build (rays and timestamps only);
    # variant 0 sets quats_start and sample_rate
    sp.set_gyro_quaternions_us(ts_us, quats[0])
    lens = load_lens_profile(inp["lens_profile"]["path"], inp["lens_profile"]["name"])
    track_frames(sp, lens, inp["video_path"], frame_begin, frame_end, method=method,
                 progress=progress, device=sp.device)
    win = sp.build_window(frame_begin, frame_end, closed=False)

    grid = presync_grid(float(inp.get("initial_guess", 0.0)) / 1000.0,
                        float(inp.get("simple_presync_radius", 200.0)) / 1000.0,
                        float(inp.get("simple_presync_step", 2.0)) / 1000.0)
    delays = torch.tensor(grid, dtype=torch.float32, device=sp.device)
    costs = _variant_costs(tables, win, delays, sp.next_generator()).double().cpu().numpy()
    best_i = costs.argmin(axis=1)
    results = [(float(costs[v, best_i[v]]), float(grid[best_i[v]]), variants[v])
               for v in range(len(variants))]
    results.sort(key=lambda r: r[0])
    return results
