"""The reference engine's golden scenes, built through the port.

tests/golden/golden.npz was produced by golden/generate.py driving the
reference's own src/core compiled unmodified (golden/README.md): P
matrices, frame losses, spline samples, PreSync / DebugPreSync and the
4-pass Sync delays and L-BFGS trajectories of six synthetic scenes.
`scene_problem` feeds one scene (from tests/synthetic.py::make_scene,
passed in by the caller) through the port's intake paths, as
golden/generate.py fed the reference and tests/test_golden.py feeds
rssync_tpu; `sync_passes` runs the reference driver's Sync passes.
tests/test_torch_golden.py and chip_smoke.py hold the port to the
artifacts with these.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rssync_tpu_torch.core import sync as sync_mod
from rssync_tpu_torch.core.api import resample_quats_us
from rssync_tpu_torch.core.problem import SplineTable, TrackWindow, build_track_window, make_spline_table
from rssync_tpu_torch.frontend.integrate import integrate_gyro_fixed_rate
from rssync_tpu_torch.ops.signal import gyro_interpolate

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "tests", "golden", "golden.npz")

# keep in lockstep with golden/generate.py::SCENES
SCENES = {
    "rot16": dict(seed=8, true_delay=-0.0442, n_frames=16, n_points=80),
    "trans12": dict(seed=3, true_delay=0.0185, n_frames=12, n_points=60,
                    translation_speed=0.8),
    "lowfeat": dict(seed=5, true_delay=0.012, n_frames=10, n_points=10),
    "trans30": dict(seed=13, true_delay=-0.021, n_frames=12, n_points=70,
                    translation_speed=2.5),
    "varrate": dict(seed=21, true_delay=0.0305, n_frames=12, n_points=60,
                    rate_jitter=0.35),
    "interp": dict(seed=34, true_delay=-0.0117, n_frames=12, n_points=60,
                   rate_jitter=0.3, gyro_rate=213.0),
}
PROBE_DELAYS = [-0.05, -0.0442, 0.0, 0.013, 0.05]
PROBE_M = np.array([0.267261, 0.534522, 0.801784])
PROBE_VARK = 250.0
SYNC_PASSES = 4       # ref core_testcode.cpp:314
SYNC_RADIUS = 0.2     # generate.py's Sync search radius around the PreSync delay

#: tolerances of tests/test_golden.py
P_ATOL = 5e-5
SPLINE_ATOL = 2e-5
SYNC_REF_TOL_S = 2.5e-4
SYNC_TRUTH_TOL_S = 5e-4


def trajectory_atol(name: str) -> float:
    """Tolerance on the L-BFGS Sync iterates and steps. interp's table is
    rates -> resample -> reintegrate: the extra interpolation noise
    flattens the loss near convergence, so later passes' iterates wander
    ~5e-5 around the same minimum; the others hold 3e-5 (the trace's 6
    significant digits plus f32)."""
    return 1e-4 if name == "interp" else 3e-5


def scene_problem(name: str, scene, golden, device) -> tuple[SplineTable, TrackWindow]:
    """The spline table and the window of all frames of one golden scene
    on `device`. `scene` is make_scene(**SCENES[name]); `golden` the
    loaded npz (the "interp" scene's rate log comes from it)."""
    cfg = SCENES[name]
    if name == "interp":
        # the reference driver's `#if 0` fixed-rate path
        # (core_testcode.cpp:20-35): the npz carries the exact angular-rate
        # log the reference consumed; the port pushes it through its
        # gyro_interpolate + fixed-dt integration
        new_ts, new_g, rate = gyro_interpolate(golden["interp/rates_ts"],
                                               golden["interp/rates"].T)
        quats = integrate_gyro_fixed_rate(new_g.T, float(rate))
        table = make_spline_table(quats, float(rate), device=device)
        quats_start, sample_rate = float(new_ts[0]), float(rate)
    elif cfg.get("rate_jitter", 0.0) > 0.0:
        # variable-rate scene: the µs intake (50 Hz rounding + SLERP
        # resample, ref core_private.cpp:142-190), as generate.py feeds it
        ts_us = np.round(np.asarray(scene.gyro_ts) * 1e6).astype(np.int64)
        rate, new_ts, new_q = resample_quats_us(ts_us, scene.quats_wxyz)
        table = make_spline_table(new_q, float(rate), device=device)
        quats_start, sample_rate = float(new_ts[0]) / 1e6, float(rate)
    else:
        table = make_spline_table(scene.quats_wxyz, scene.gyro_rate, device=device)
        quats_start, sample_rate = float(scene.gyro_ts[0]), scene.gyro_rate
    frames = sorted(scene.frames)
    win = build_track_window(
        *([scene.frames[f][i] for f in frames] for i in range(4)),
        quats_start=quats_start, sample_rate=sample_rate, device=device,
    )
    return table, win


def sync_passes(table: SplineTable, win: TrackWindow, start: float, motion_opt: str,
                passes: int = SYNC_PASSES) -> list:
    """The reference driver's Sync passes (core_testcode.cpp:308-314)
    from the reference's PreSync delay `start`, each searching it
    +- SYNC_RADIUS, pass p drawing from a generator seeded 10 + p.
    Returns each pass's SyncResult."""
    dev = win.counts.device
    results, delay = [], start
    for p in range(passes):
        res = sync_mod.sync_window(
            table, win, delay, start, SYNC_RADIUS,
            torch.Generator(device=dev).manual_seed(10 + p), motion_opt=motion_opt)
        results.append(res)
        delay = float(res.delay)
    return results
