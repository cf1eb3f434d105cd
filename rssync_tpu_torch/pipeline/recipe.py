"""Gyro intake from a telemetry file or a rate log, and the batched
syncpoint run (ref: src/core_testcode.cpp:37-54, :270-316).

Per syncpoint the reference runs an optional PreSync, then 4 Sync
re-estimation passes with search_center = initial_delay and radius =
the PreSync radius or infinity. Here every syncpoint window is stacked
and the clip syncs as one batched PreSync + 4 batched Sync passes.
`run_batched` chains the three stages below; a caller that times the
stages apart calls them in the same order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rssync_tpu_torch.core.api import SyncProblem
from rssync_tpu_torch.core.presync import presync_grid
from rssync_tpu_torch.core.problem import TrackWindow
from rssync_tpu_torch.core.sync import SyncResult
from rssync_tpu_torch.frontend.integrate import integrate_gyro
from rssync_tpu_torch.frontend.telemetry import apply_orientation, load_gyro
from rssync_tpu_torch.parallel.batch import batched_presync, batched_sync, stack_windows

SYNC_PASSES = 4  # ref core_testcode.cpp:314


def gyro_timestamps_us(timestamps: np.ndarray) -> np.ndarray:
    """Gyro timestamps in seconds as the integer us the variable-rate
    intake takes: truncated toward zero, as rssync_tpu's fill_gyro and
    guess_orient convert them (k / 200 s for k < 12 000 gives 151
    timestamps 1 us below rounding)."""
    return (np.asarray(timestamps, np.float64) * 1_000_000).astype(np.int64)


def fill_gyro(problem: SyncProblem, gyro_path: str, orient: str | None) -> None:
    """optdata_fill_gyro (ref: core_testcode.cpp:37-54): load the
    telemetry file (any format `load_gyro` reads, axes remapped by
    `orient`), integrate the rates into orientations, and feed the
    variable-rate intake with the timestamps in integer us."""
    data = load_gyro(gyro_path, orient)
    quats = integrate_gyro(data.timestamps, data.gyro)
    problem.set_gyro_quaternions_us(gyro_timestamps_us(data.timestamps), quats)


def set_gyro_rates(problem: SyncProblem, timestamps: np.ndarray, rates: np.ndarray,
                   orient: str | None) -> None:
    """The in-memory form of `fill_gyro` (ref: core_testcode.cpp:37-54):
    remap the axes by `orient`, integrate the rates into orientations,
    and feed the variable-rate intake with the timestamps in integer us
    (`gyro_timestamps_us`). timestamps: (n,) seconds; rates: (n, 3)
    rad/s."""
    quats = integrate_gyro(timestamps, apply_orientation(np.asarray(rates, np.float64), orient))
    problem.set_gyro_quaternions_us(gyro_timestamps_us(timestamps), quats)


def window_pair_ranges(syncpoints: list[int], sync_window: int) -> list[tuple[int, int]]:
    """The frame pairs the batched run reads, as (begin, end) ranges with
    end exclusive: the closed Sync window [p, p + sync_window] of every
    syncpoint (PreSync's half-open window lies inside it)."""
    return [(p, p + sync_window + 1) for p in syncpoints]


def make_syncpoints(params: dict, frame_start: int, frame_end: int) -> list[int]:
    """Syncpoint schedule (ref: core_testcode.cpp:270-280)."""
    fmt = params.get("syncpoints_format", "auto")
    if fmt == "auto":
        window = int(params["sync_window"])
        dist = int(params["syncpoint_distance"])
        out, pos = [], frame_start
        while pos + window < frame_end:
            out.append(pos)
            pos += dist
        return out
    if fmt == "array":
        return [int(p) for p in params["syncpoints_array"]]
    raise ValueError(f"unknown syncpoints_format {fmt!r}")


def syncpoint_windows(
    sp: SyncProblem, syncpoints: list[int], sync_window: int
) -> tuple[TrackWindow, TrackWindow]:
    """The stacked windows of every syncpoint: [p, p + sync_window) for
    PreSync and [p, p + sync_window] for Sync."""
    return tuple(
        stack_windows([sp.build_window(p, p + sync_window, closed=c) for p in syncpoints])
        for c in (False, True)
    )


def presync_stage(
    sp: SyncProblem, open_wins: TrackWindow, initial_delay: float,
    presync_radius_ms: float, presync_step_ms: float,
) -> torch.Tensor:
    """One batched PreSync over the delay grid; the best delay of every
    window (W,)."""
    f32 = dict(dtype=torch.float32, device=sp.device)
    grid = presync_grid(initial_delay, presync_radius_ms / 1000.0, presync_step_ms / 1000.0)
    _, delays = batched_presync(
        sp.spline_table, open_wins, torch.tensor(grid, **f32), sp.next_generator()
    )
    return delays


def sync_stage(
    sp: SyncProblem, closed_wins: TrackWindow, delays: torch.Tensor,
    initial_delay: float, radius: float, motion_opt: str = "irls",
) -> list[SyncResult]:
    """SYNC_PASSES batched Sync passes from `delays` (W,), each searching
    initial_delay +- radius, refining the motion by `motion_opt`
    ("irls" or "lbfgs"); the result of every pass."""
    centers = torch.full_like(delays, initial_delay)
    results = []
    for _ in range(SYNC_PASSES):
        results.append(batched_sync(
            sp.spline_table, closed_wins, delays, centers, radius, sp.next_generator(),
            motion_opt,
        ))
        delays = results[-1].delay
    return results


def run_batched(
    sp: SyncProblem, syncpoints: list[int], sync_window: int,
    initial_delay: float, use_presync: bool, presync_radius_ms: float,
    presync_step_ms: float,
) -> list[float]:
    """All syncpoints as one stacked batch: one batched PreSync over the
    delay grid, then SYNC_PASSES batched Sync passes. Returns the delay
    of every syncpoint in milliseconds."""
    if not syncpoints:
        return []
    open_wins, closed_wins = syncpoint_windows(sp, syncpoints, sync_window)
    radius = math.inf
    delays = torch.full((len(syncpoints),), initial_delay, dtype=torch.float32, device=sp.device)
    if use_presync:
        radius = presync_radius_ms / 1000.0
        delays = presync_stage(sp, open_wins, initial_delay, presync_radius_ms, presync_step_ms)
    delays = sync_stage(sp, closed_wins, delays, initial_delay, radius)[-1].delay
    return [1000.0 * d for d in delays.double().cpu().tolist()]
