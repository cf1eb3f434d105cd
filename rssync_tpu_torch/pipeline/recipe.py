"""The end-to-end batch pipeline: JSON recipe in, sync CSV out
(ref: src/core_testcode.cpp:235-319), and its gyro intake from a
telemetry file or a rate log (ref: :37-54).

The recipe schema is the reference's (README.md:15-44; times in
milliseconds), and so are the outputs: a `<frame>,<delay_ms>` sync CSV
(ref :315) and an always-written 200-point `debug.csv` loss surface of
the first window (ref :285-301). Per syncpoint the reference runs an
optional PreSync, then 4 Sync re-estimation passes with search_center =
initial_delay and radius = the PreSync radius or infinity (ref
:308-314). Two execution modes:

  batched=True (default): every syncpoint window is stacked and the
    clip syncs as one batched PreSync + 4 batched Sync passes
    (`run_batched` chains the three stages `syncpoint_windows`,
    `presync_stage`, `sync_stage`; a caller that times the stages
    apart calls them in the same order);
  batched=False: sequential per-syncpoint calls, the reference's
    control flow exactly.

A copy of rssync_tpu/pipeline/recipe.py on the port's engine and
tracker. Entry points run on the card unless `device="cpu"` is given;
rssync_tpu's engine compile warm-up (`_start_engine_warm`) is not
ported, since nothing here compiles at first call.
"""

from __future__ import annotations

import json
import math
import sys
from dataclasses import dataclass

import numpy as np
import torch

from rssync_tpu_torch.core.api import SyncProblem
from rssync_tpu_torch.core.presync import presync_grid
from rssync_tpu_torch.core.problem import TrackWindow
from rssync_tpu_torch.core.sync import SyncResult
from rssync_tpu_torch.frontend.integrate import integrate_gyro
from rssync_tpu_torch.frontend.lens_profiles import load_lens_profile
from rssync_tpu_torch.frontend.telemetry import apply_orientation, load_gyro
from rssync_tpu_torch.parallel.batch import batched_presync, batched_sync, stack_windows
from rssync_tpu_torch.utils import track_cache
from rssync_tpu_torch.utils.timing import Timings

SYNC_PASSES = 4  # ref core_testcode.cpp:314
DEBUG_PLOT_SIZE = 200  # ref :288


@dataclass
class RecipeResult:
    syncpoints: list[int]
    delays_ms: list[float]
    csv_path: str | None
    debug_csv_path: str | None


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
    presync_step_ms: float, trace: bool = False,
) -> list[float]:
    """All syncpoints as one stacked batch: one batched PreSync over the
    delay grid, then SYNC_PASSES batched Sync passes. Returns the delay
    of every syncpoint in milliseconds.

    trace=True prints the reference's per-iteration `delay step` lines
    (ref core_private.cpp:330) of every window after each pass to
    stderr, read from the SyncResult trace buffers: the batched form of
    the sequential mode's live stream, in rssync_tpu's format."""
    if not syncpoints:
        return []
    open_wins, closed_wins = syncpoint_windows(sp, syncpoints, sync_window)
    radius = math.inf
    delays = torch.full((len(syncpoints),), initial_delay, dtype=torch.float32, device=sp.device)
    if use_presync:
        radius = presync_radius_ms / 1000.0
        delays = presync_stage(sp, open_wins, initial_delay, presync_radius_ms, presync_step_ms)
    results = sync_stage(sp, closed_wins, delays, initial_delay, radius)
    if trace:
        for i, res in enumerate(results):
            iters = res.iterations.cpu().numpy()
            tr_d = res.trace_delay.double().cpu().numpy()
            tr_s = res.trace_step.double().cpu().numpy()
            for w, pos in enumerate(syncpoints):
                print(f"# pass {i} window {pos} ({iters[w]} iters)", file=sys.stderr)
                for it in range(int(iters[w])):
                    print(f"{tr_d[w, it]:g} {abs(tr_s[w, it]):g}", file=sys.stderr)
    return [1000.0 * d for d in results[-1].delay.double().cpu().tolist()]


def run_sequential(
    sp: SyncProblem, syncpoints: list[int], sync_window: int,
    initial_delay: float, use_presync: bool, presync_radius_ms: float,
    presync_step_ms: float, progress: bool = False,
) -> list[float]:
    """The reference's control flow exactly (ref :303-316): per
    syncpoint an optional `pre_sync`, then SYNC_PASSES `sync` calls.
    Returns the delay of every syncpoint in milliseconds."""
    out = []
    for pos in syncpoints:
        if progress:
            print(pos, flush=True)
        delay = initial_delay
        radius = math.inf
        if use_presync:
            radius = presync_radius_ms / 1000.0
            _, delay = sp.pre_sync(delay, pos, pos + sync_window, presync_step_ms / 1000.0,
                                   radius)
        for _ in range(SYNC_PASSES):
            _, delay = sp.sync(delay, pos, pos + sync_window, initial_delay, radius)
        out.append(1000.0 * delay)
    return out


# ---------------------------------------------------------------------------
# the recipe


def _load_recipe(recipe) -> dict:
    if isinstance(recipe, (str, bytes)):
        with open(recipe) as f:
            return json.load(f)
    if hasattr(recipe, "read"):
        return json.load(recipe)
    return recipe


def _window_pair_ranges(recipe: dict) -> list[tuple[int, int]]:
    """Pair ranges the engine will read: every syncpoint window plus the
    debug.csv first window (rssync_tpu/pipeline/recipe.py:89-101).
    Decoding only these skips inter-window frames with identical
    outputs: the reference decodes everything but never reads
    inter-window pairs (core_testcode.cpp:99-122)."""
    params = recipe["params"]
    frame_start, frame_end = (int(v) for v in recipe["input"]["frame_range"])
    window = int(params["sync_window"])
    pts = make_syncpoints(params, frame_start, frame_end)
    return window_pair_ranges(pts, window) + [(frame_start, frame_start + window + 1)]


def _prepare_problem(recipe: dict, method: str, seed: int, track_cache_dir: str | None,
                     timings: Timings, progress: bool, decode_scope: str = "windows",
                     device="cuda") -> tuple[SyncProblem, int, int]:
    """Gyro + track intake of one recipe -> (SyncProblem, frame range).

    decode_scope: "windows" decodes and tracks only the pairs inside
    syncpoint windows (and the debug.csv window); "full" decodes the
    whole frame_range (the reference's behavior: same outputs, slower
    host decode)."""
    from rssync_tpu_torch.frontend.tracking import _merge_pair_ranges, track_frames

    inp = recipe["input"]
    sp = SyncProblem(seed=seed, device=device)
    with timings.stage("gyro_ingest"):
        fill_gyro(sp, inp["gyro_path"], inp.get("gyro_orientation"))
    lens = load_lens_profile(inp["lens_profile"]["path"], inp["lens_profile"]["name"])
    frame_start, frame_end = (int(v) for v in inp["frame_range"])
    if decode_scope == "windows":
        ranges = _merge_pair_ranges(_window_pair_ranges(recipe), frame_start, frame_end)
        if ranges == [(frame_start, frame_end)]:
            ranges = None  # windows tile the whole span: same as full
    elif decode_scope == "full":
        ranges = None
    else:
        raise ValueError(f"unknown decode_scope {decode_scope!r}")
    key = track_cache.cache_key(
        inp["video_path"], frame_start, frame_end, inp.get("grid_step"), method,
        tuple(lens.as_array()), ranges=ranges,
    ) if track_cache_dir else ""
    with timings.stage("tracking"):
        hit = track_cache.tracks_cached_or_compute(
            sp, track_cache_dir, key,
            lambda: track_frames(
                sp, lens, inp["video_path"], frame_start, frame_end,
                grid_step=inp.get("grid_step"), method=method, progress=progress,
                ranges=ranges, device=device,
            ),
        )
    if progress and hit:
        print(f"# tracks from {track_cache.cache_path(track_cache_dir, key)}", flush=True)
    return sp, frame_start, frame_end


def run_recipe(recipe, method: str = "lk", seed: int = 0, batched: bool = True,
               progress: bool = False, track_cache_dir: str | None = None,
               timings: Timings | None = None, trace: bool = False,
               decode_scope: str = "windows", device="cuda") -> RecipeResult:
    """Execute a recipe (path, file object, or dict) on `device`.

    track_cache_dir: optional directory caching the track stage, so
    sync experiments re-run without re-decoding video.
    timings: optional utils.timing.Timings collecting per-stage wall
    clock (gyro_ingest, tracking, debug_presync, sync_all; each stage
    ends on a host read of its results, so it times its card work).
    trace: print the per-iteration `delay step` lines of batched Sync.
    decode_scope: "windows" (default) decodes only syncpoint-window
    pairs; "full" decodes the whole frame_range (identical outputs).
    """
    timings = timings if timings is not None else Timings()
    recipe = _load_recipe(recipe)
    inp = recipe["input"]
    params = recipe["params"]
    output = recipe.get("output", {})

    sp, frame_start, frame_end = _prepare_problem(
        recipe, method, seed, track_cache_dir, timings, progress,
        decode_scope=decode_scope, device=device,
    )
    sync_window = int(params["sync_window"])
    syncpoints = make_syncpoints(params, frame_start, frame_end)

    initial_delay = float(inp.get("initial_guess", 0.0)) / 1000.0
    use_presync = bool(inp.get("use_simple_presync", False))
    presync_radius_ms = float(inp.get("simple_presync_radius", 200.0))
    presync_step_ms = float(inp.get("simple_presync_step", 2.0))

    # debug.csv: loss surface of the first window (ref :285-301)
    debug_csv_path = output.get("debug_csv_path", "debug.csv")
    if debug_csv_path:
        with timings.stage("debug_presync"):
            delays, costs = sp.debug_pre_sync(
                initial_delay, frame_start, frame_start + sync_window,
                presync_radius_ms / 1000.0, DEBUG_PLOT_SIZE,
            )
        with open(debug_csv_path, "w") as f:
            for d, c in zip(delays, costs):
                f.write(f"{d:g},{c:g}\n")

    with timings.stage("sync_all"):
        # an empty schedule (sync_window does not fit the frame range)
        # writes an empty CSV, as the reference's loop that never runs
        # does (ref :303-316)
        args = (sp, syncpoints, sync_window, initial_delay, use_presync,
                presync_radius_ms, presync_step_ms)
        if batched:
            delays_ms = run_batched(*args, trace=trace)
        else:
            delays_ms = run_sequential(*args, progress=progress)
    if progress:
        print(timings.report(), flush=True)

    csv_path = output.get("csv_path")
    if csv_path:
        # output.gyroflow_offsets (opt-in): a third column with the
        # value for GyroFlow's manual offset field (sign flip + lens.ro/2
        # frame-center shift, the thesis's convention, thesis p.15/p.32)
        gf_ro = None
        if bool(output.get("gyroflow_offsets", False)):
            from rssync_tpu_torch.analysis.metrics import to_gyroflow_offset

            gf_ro = load_lens_profile(inp["lens_profile"]["path"],
                                      inp["lens_profile"]["name"]).ro
        with open(csv_path, "w") as f:
            for pos, dms in zip(syncpoints, delays_ms):
                if gf_ro is None:
                    f.write(f"{pos},{dms:g}\n")
                else:
                    gf_ms = 1000.0 * to_gyroflow_offset(dms / 1000.0, gf_ro)
                    f.write(f"{pos},{dms:g},{gf_ms:g}\n")

    return RecipeResult(syncpoints=syncpoints, delays_ms=delays_ms, csv_path=csv_path,
                        debug_csv_path=debug_csv_path)


def run_multi_recipes(recipes, method: str = "lk", seed: int = 0, progress: bool = False,
                      track_cache_dir: str | None = None, decode_scope: str = "windows",
                      device="cuda") -> list[RecipeResult]:
    """Sync N clips as one batched engine run on `device`.

    Every recipe's gyro and tracks load into its own SyncProblem; all
    clips' syncpoint windows then stack into one window axis with
    per-window spline tables (parallel/multi.py::sync_clips): one
    PreSync and 4 Sync passes for the whole fleet. Each recipe keeps its
    own sync_window, initial_guess and simple-presync radius and step.
    The one constraint: use_simple_presync must be on for every recipe,
    since the stacked tables need a bounded delay swing.
    """
    from rssync_tpu_torch.parallel.multi import sync_clips

    timings = Timings()
    loaded = [_load_recipe(r) for r in recipes]
    for r in loaded:
        if not bool(r["input"].get("use_simple_presync", False)):
            raise ValueError("multi-clip mode requires use_simple_presync")
    windows = [int(r["params"]["sync_window"]) for r in loaded]
    inits = [float(r["input"].get("initial_guess", 0.0)) / 1000.0 for r in loaded]
    radii = [float(r["input"].get("simple_presync_radius", 200.0)) / 1000.0 for r in loaded]
    steps = [float(r["input"].get("simple_presync_step", 2.0)) / 1000.0 for r in loaded]

    problems, syncpoint_lists = [], []
    for i, r in enumerate(loaded):
        sp, fs, fe = _prepare_problem(r, method, seed + i, track_cache_dir, timings, progress,
                                      decode_scope=decode_scope, device=device)
        problems.append(sp)
        syncpoint_lists.append(make_syncpoints(r["params"], fs, fe))

    with timings.stage("sync_all_clips"):
        delay_lists = sync_clips(problems, syncpoint_lists, windows, inits, steps, radii,
                                 problems[0].next_generator(), sync_passes=SYNC_PASSES)
    if progress:
        print(timings.report(), flush=True)

    results = []
    for r, pts, ds in zip(loaded, syncpoint_lists, delay_lists):
        delays_ms = [1000.0 * d for d in ds]
        csv_path = r.get("output", {}).get("csv_path")
        if csv_path:
            with open(csv_path, "w") as f:
                for pos, dms in zip(pts, delays_ms):
                    f.write(f"{pos},{dms:g}\n")
        results.append(RecipeResult(syncpoints=pts, delays_ms=delays_ms, csv_path=csv_path,
                                    debug_csv_path=None))
    return results
