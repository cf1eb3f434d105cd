"""The ported engine as a whole, on a small synthetic clip: the public
SyncProblem calls and the batched run recover the delay, agree with
rssync_tpu on the same inputs, keep the reference's error paths, and
reproduce per seed."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import rssync_tpu
from rssync_tpu.pipeline.recipe import _run_batched as jax_run_batched
from rssync_tpu.testing.engine_problem import make_engine_problem as jmake
from rssync_tpu_torch import create_sync_problem
from rssync_tpu_torch.pipeline.recipe import (
    SYNC_PASSES,
    make_syncpoints,
    presync_stage,
    run_batched,
    sync_stage,
    syncpoint_windows,
)
from rssync_tpu_torch.testing.engine_problem import make_engine_problem as tmake
from rssync_tpu_torch.utils.checks import SyncPanic

torch.set_num_threads(2)

#: 4 windows of 12 frames x 40 features, 30 fps, 200 Hz gyro
SCENE = dict(seed=1, duration=4.0, fps=30.0, n_features=40, sync_window=12,
             syncpoint_distance=30, true_delay=0.0173)
WINDOW = SCENE["sync_window"]
#: the accuracy target of the engine, and the agreement with rssync_tpu
#: (both are f32 optimizations of the same loss from different RANSAC
#: draws; measured 0.002 ms apart on this scene)
TRUTH_TOL_S, JAX_TOL_S = 5e-4, 1e-4


@pytest.fixture(scope="module")
def scene():
    return tmake(**SCENE)


def _problem(scene, seed=0):
    sp = create_sync_problem(seed, device="cpu")
    scene.feed(sp)
    return sp


@pytest.fixture(scope="module")
def jax_delays(scene):
    """rssync_tpu's batched run on the same gyro log and tracks, fed
    through its public SyncProblem intake."""
    sp = rssync_tpu.create_sync_problem(seed=0)
    scene.feed(sp)
    ms = jax_run_batched(sp, scene.syncpoints, WINDOW, 0.0, True, 200.0, 2.0, False)
    return np.asarray(ms) / 1000.0


def test_engine_problem_equals_jax(scene):
    jp = jmake(**SCENE)
    assert jp.syncpoints == scene.syncpoints
    np.testing.assert_array_equal(
        scene.table("cpu").coeffs.numpy(), np.asarray(jp.table.coeffs))
    for jw, tw in zip(jp.windows, scene.windows("cpu")):
        for name in ("rays_a", "rays_b", "i0_a", "i0_b", "f0_a", "f0_b", "counts"):
            np.testing.assert_array_equal(
                getattr(tw, name).numpy(), np.asarray(getattr(jw, name)), err_msg=name)


def test_run_batched_recovers_delay(scene, jax_delays):
    sp = _problem(scene)
    assert make_syncpoints(
        {"sync_window": WINDOW, "syncpoint_distance": 30}, 0, 120) == scene.syncpoints
    got = np.asarray(run_batched(sp, scene.syncpoints, WINDOW, 0.0, True, 200.0, 2.0)) / 1000.0
    assert np.abs(got - scene.true_delay).max() < TRUTH_TOL_S
    assert np.abs(got - jax_delays).max() < JAX_TOL_S


def test_sync_problem_recovers_delay(scene, jax_delays):
    """pre_sync then SYNC_PASSES x sync on the first window, as the
    reference main loop does per syncpoint."""
    sp = _problem(scene)
    cost, delay = sp.pre_sync(0.0, 0, WINDOW, 0.002, 0.2)
    assert np.isfinite(cost) and abs(delay - scene.true_delay) < 0.003
    for _ in range(SYNC_PASSES):
        cost, delay = sp.sync(delay, 0, WINDOW, 0.0, 0.2)
    assert np.isfinite(cost)
    assert abs(delay - scene.true_delay) < TRUTH_TOL_S
    assert abs(delay - jax_delays[0]) < JAX_TOL_S


def test_debug_pre_sync_surface_and_point_count(scene):
    sp = _problem(scene)
    delays, costs = sp.DebugPreSync(0.0, 0, WINDOW, 0.1, 51)
    assert len(delays) == 51
    assert delays[0] == pytest.approx(-0.1) and delays[-1] == pytest.approx(0.1)
    assert abs(delays[np.argmin(costs)] - scene.true_delay) < 0.003
    for bad in (1, 0):
        with pytest.raises(SyncPanic, match="point_count"):
            sp.debug_pre_sync(0.0, 0, WINDOW, 0.05, bad)
    delays, costs = sp.debug_pre_sync(0.0, 0, WINDOW, 0.05, 2)
    assert len(delays) == 2 and np.isfinite(costs).all()


def test_error_paths(scene):
    sp = create_sync_problem(device="cpu")
    _, ts_a, ts_b, ra, rb = next(scene.frames())
    sp.set_track_result(0, ts_a, ts_b, ra, rb)
    with pytest.raises(RuntimeError, match="SetGyroQuaternions"):
        sp.pre_sync(0.0, 0, 5, 0.01, 0.1)
    bad = ra.copy()
    bad[0, 0] = np.nan
    with pytest.raises(SyncPanic, match="rays_a"):
        sp.SetTrackResult(0, ts_a, ts_b, bad, rb)
    ts_us = (np.arange(100) * 5000).astype(np.int64)
    ts_us[10] = ts_us[9] - 100
    with pytest.raises(SyncPanic, match="out of order"):
        sp.set_gyro_quaternions_us(ts_us, np.tile([1.0, 0.0, 0.0, 0.0], (100, 1)))
    with pytest.raises(ValueError, match="wxyz"):
        sp.set_gyro_quaternions(np.zeros((10, 3)), 200.0, 0.0)
    with pytest.raises(RuntimeError, match="no track data"):
        _problem(scene).sync(0.0, 500, 510)
    if torch.cuda.is_available():
        assert create_sync_problem(device="cuda").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_sync_problem(device="cuda")


def test_variable_rate_intake_rounds_to_grid(scene):
    """The µs overload resamples onto the 50 Hz-rounded grid and keeps
    the delay (ref core_private.cpp:142-190)."""
    rng = np.random.default_rng(1)
    n = scene.quats.shape[0]
    ts = scene.quats_start + np.arange(n) / scene.gyro_rate
    ts_us = np.round((ts + rng.uniform(-5e-4, 5e-4, n)) * 1e6).astype(np.int64)
    sp = create_sync_problem(device="cpu")
    sp.SetGyroQuaternions(np.sort(ts_us), scene.quats)
    assert sp._sample_rate == scene.gyro_rate
    for f, ts_a, ts_b, ra, rb in scene.frames():
        sp.set_track_result(f, ts_a, ts_b, ra, rb)
    _, delay = sp.pre_sync(0.0, 0, WINDOW, 0.002, 0.2)
    _, delay = sp.sync(delay, 0, WINDOW, 0.0, 0.2)
    assert abs(delay - scene.true_delay) < 1e-3


def test_deterministic_per_seed(scene):
    runs = []
    for _ in range(2):
        sp = _problem(scene, seed=123)
        runs.append((
            sp.pre_sync(0.0, 0, WINDOW, 0.004, 0.1),
            sp.sync(0.02, 0, WINDOW, 0.0, 0.1),
            run_batched(sp, scene.syncpoints[:2], WINDOW, 0.0, True, 40.0, 4.0),
        ))
    assert runs[0] == runs[1]


def test_stages_chain_to_run_batched(scene):
    """The stages chip_smoke.py times separately are run_batched's own:
    chained on the same seed they give its delays bit for bit."""
    want = run_batched(_problem(scene), scene.syncpoints[:2], WINDOW, 0.0, True, 40.0, 4.0)
    sp = _problem(scene)
    open_wins, closed_wins = syncpoint_windows(sp, scene.syncpoints[:2], WINDOW)
    best = presync_stage(sp, open_wins, 0.0, 40.0, 4.0)
    results = sync_stage(sp, closed_wins, best, 0.0, 0.04)
    assert len(results) == SYNC_PASSES
    assert [1000.0 * d for d in results[-1].delay.double().tolist()] == want


#: tests/test_edgecases.py's scene: 8 frames x 40 points, delay 20 ms
EDGE_SCENE = dict(seed=3, true_delay=0.02, n_frames=8, n_points=40)


@pytest.fixture(scope="module")
def edge_scene():
    from synthetic import make_scene

    return make_scene(**EDGE_SCENE)


def _edge_problem(scene, mangle=None):
    sp = create_sync_problem(seed=0, device="cpu")
    sp.set_gyro_quaternions(scene.quats_wxyz, scene.gyro_rate, float(scene.gyro_ts[0]))
    for f, d in scene.frames.items():
        sp.set_track_result(f, *(mangle(f, d) if mangle else d))
    return sp


def test_sparse_frame_counts_amid_valid(edge_scene):
    """Frames carrying 0 or 1 correspondences between full frames are
    masked out; the other frames still recover the delay
    (tests/test_edgecases.py:55)."""

    def mangle(f, d):
        if f == 2:  # one lone feature
            return tuple(x[:1] for x in d)
        if f == 4:  # no features at all
            return tuple(x[:0] for x in d)
        return d

    sp = _edge_problem(edge_scene, mangle)
    cost, delay = sp.pre_sync(0.0, 0, 8, 0.002, 0.05)
    assert np.isfinite(cost)
    assert abs(delay - EDGE_SCENE["true_delay"]) < 0.004
    cost, delay = sp.sync(delay, 0, 7, 0.0, 0.05)
    assert np.isfinite(cost) and np.isfinite(delay)
    assert abs(delay - EDGE_SCENE["true_delay"]) < 0.001


def test_zero_flow_window_finite(edge_scene):
    """rays_b == rays_a everywhere (a static clip): the epipolar rows
    degenerate, but costs stay finite and Sync ends inside its radius
    guard instead of producing NaN (tests/test_edgecases.py:76)."""
    sp = _edge_problem(edge_scene, lambda f, d: (d[0], d[1], d[2], d[2]))
    cost, delay = sp.pre_sync(0.0, 0, 8, 0.002, 0.05)
    assert np.isfinite(cost) and np.isfinite(delay)
    cost, delay = sp.sync(0.0, 0, 7, 0.0, 0.05)
    assert np.isfinite(cost) and np.isfinite(delay)
    assert abs(delay) <= 0.05 + 1e-6  # inside the search radius


def test_profile_busy_time_is_a_union():
    from rssync_tpu_torch.testing.profile_engine import _union_us

    assert _union_us([]) == 0.0
    assert _union_us([(5.0, 9.0), (0.0, 2.0), (1.0, 3.0), (6.0, 7.0)]) == 7.0


def test_port_imports_neither_jax_nor_rssync_tpu(tmp_path):
    """Every port module (the CLI and the decoder pool among them), one
    engine call, a file intake through fill_gyro and one L-BFGS Sync
    window leave JAX and the JAX package out of the interpreter, and
    import with cv2 unimportable."""
    gcsv = tmp_path / "log.gcsv"
    gcsv.write_text("GYROFLOW IMU LOG\ntscale,0.001\ngscale,0.001\nt,gx,gy,gz\n" + "".join(
        f"{i * 5},{300 * np.sin(i / 40):.0f},{200 * np.cos(i / 30):.0f},{100 * np.sin(i / 20):.0f}\n"
        for i in range(400)))
    pkg = Path(__file__).resolve().parent.parent / "rssync_tpu_torch"
    mods = sorted(
        ".".join(p.relative_to(pkg.parent).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py")
    )
    code = "\n".join([
        "import importlib, sys",
        "sys.modules['cv2'] = None  # import cv2 raises ImportError",
        f"for m in {mods!r}: importlib.import_module(m)",
        "for m in ('rssync_tpu_torch.pipeline.__main__', 'rssync_tpu_torch.frontend.decode_pool',",
        "          'rssync_tpu_torch.parallel.multi', 'rssync_tpu_torch.pipeline.guess_orient',",
        "          'rssync_tpu_torch.parallel.mesh', 'rssync_tpu_torch.analysis.plot'):",
        "    assert m in sys.modules, m",
        "from rssync_tpu_torch.testing.engine_problem import make_engine_problem",
        "from rssync_tpu_torch import create_sync_problem",
        "prob = make_engine_problem(duration=1.0, fps=30.0, n_features=12,",
        "                           sync_window=6, syncpoint_distance=10)",
        "sp = create_sync_problem(device='cpu'); prob.feed(sp)",
        "print(sp.pre_sync(0.0, 0, 6, 0.01, 0.05))",
        "import torch",
        "from rssync_tpu_torch.core.sync import sync_window",
        "res = sync_window(sp.spline_table, sp.build_window(0, 6, closed=True), 0.0, 0.0, 0.05,",
        "                  torch.Generator().manual_seed(0), motion_opt='lbfgs')",
        "assert int(res.motion_iterations) > 0, res",
        "from rssync_tpu_torch.pipeline.recipe import fill_gyro",
        f"fill_gyro(sp, {str(gcsv)!r}, 'xyz')",
        "assert sp._sample_rate == 200.0",
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))",
        "       or m == 'rssync_tpu' or m.startswith('rssync_tpu.')]",
        "assert not bad, bad",
    ])
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=pkg.parent, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_sync_does_not_cycle_on_30fps_tracks():
    """A bad draw, replayed on the CPU: the tracks the tracker emitted on
    an H100 for window 0 of hero6-30.clip's clip at seed 2200000311
    (tests/data/hero6_30fps_2200000311_window0.npz: its 61 pairs' tracked
    rays and rows, the grid's rays), the clip's gyro log, and the
    problem of seed 1000. Without the IRLS momentum restart
    (core/sync.py), pass 0 ran its 400 outer trips here, the delay and
    14 frames' directions in a 4-trip cycle (steps of +-1.1 ms and +-0.01
    ms), 0.3-0.8 ms off the scene's delay; with it every pass stops in a
    few trips."""
    import json

    from portbench import harness
    from portbench.reference import truth
    from rssync_tpu_torch.frontend.tracking import grid_points, rolling_shutter_ts
    from rssync_tpu_torch.ops.lens import Lens
    from rssync_tpu_torch.pipeline.recipe import set_gyro_rates

    root = Path(__file__).resolve().parent
    cfg = json.loads((root.parent / "portbench/configs/hero6_2704x2028_30fps.json").read_text())
    clip = harness.make_clip(cfg, 2200000311, "cpu", render=False)
    data = np.load(root / "data/hero6_30fps_2200000311_window0.npz")
    lens, H = Lens(**vars(clip.lens)), clip.height
    grid = grid_points(clip.width, H, 200)
    rays_a = data["rays_a"].astype(np.float64)
    sp = create_sync_problem(seed=1000, device="cpu")
    set_gyro_rates(sp, clip.gyro_ts, clip.gyro_rates, "xyz")
    for i, (rays_b, rows_b) in enumerate(zip(data["rays_b"], data["rows_b"])):
        tracked = np.stack([np.zeros_like(rows_b), rows_b], axis=-1)  # only rows set times
        ts_a, ts_b = rolling_shutter_ts(lens, grid, tracked, clip.frame_ts[i],
                                        clip.frame_ts[i + 1], H)
        sp.set_track_result(i, ts_a, ts_b, rays_a, rays_b.astype(np.float64))
    open_w, closed_w = syncpoint_windows(sp, [0], 60)
    pre = presync_stage(sp, open_w, clip.initial_delay, 200.0, 2.0)
    res = sync_stage(sp, closed_w, pre, clip.initial_delay, 0.2)
    want = float(truth.window_delays(clip.syncpoints[:1], clip.fps, 60, clip.engine_delay,
                                     clip.drift)[0])
    assert [int(r.iterations[0]) < 50 for r in res] == [True] * SYNC_PASSES
    assert abs(float(res[-1].delay[0]) - want) < 1e-4
