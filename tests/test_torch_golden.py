"""Golden parity of the port against the REAL reference engine.

tests/golden/golden.npz was produced by golden/generate.py driving the
reference's own src/core compiled unmodified (golden/README.md).
tests/test_golden.py holds rssync_tpu to it; this file runs every one of
its tests on rssync_tpu_torch, on the CPU, at the same tolerances: P
matrices, frame losses with their delay and motion gradients (autograd),
raw spline samples, PreSync / DebugPreSync, 4-pass IRLS Sync and the
4-pass L-BFGS Sync trajectories. The RANSAC draws come from
torch.Generator instead of jax.random, as in rssync_tpu's tests the
draws differ from the reference's.

The scenes and tolerances are rssync_tpu_torch/testing/golden.py's
(its SCENES must match golden/generate.py::SCENES exactly); chip_smoke.py
runs the same comparisons on the card.
"""

import functools

import numpy as np
import pytest
import torch

from rssync_tpu_torch.core import presync as presync_mod
from rssync_tpu_torch.core import sync as sync_mod
from rssync_tpu_torch.core.api import resample_quats_us
from rssync_tpu_torch.core.problem import compute_problem
from rssync_tpu_torch.ops.spline import eval_spline_packed
from rssync_tpu_torch.testing.golden import (
    GOLDEN,
    P_ATOL,
    PROBE_DELAYS,
    PROBE_M,
    PROBE_VARK,
    SCENES,
    SPLINE_ATOL,
    SYNC_REF_TOL_S,
    SYNC_TRUTH_TOL_S,
    scene_problem,
    sync_passes,
    trajectory_atol,
)

from synthetic import make_scene

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@functools.lru_cache(maxsize=None)
def problem(name):
    """(scene, table, window) of one golden scene on the CPU, once per
    scene (make_scene integrates its trajectory on the host)."""
    scene = make_scene(**SCENES[name])
    return (scene, *scene_problem(name, scene, np.load(GOLDEN), CPU))


def test_varrate_gyro_params_match_reference(golden):
    """The µs intake's integer arithmetic (rate estimate, 50 Hz
    rounding, grid start) agrees with the reference exactly."""
    scene = make_scene(**SCENES["varrate"])
    ts_us = np.round(np.asarray(scene.gyro_ts) * 1e6).astype(np.int64)
    rate, new_ts, _ = resample_quats_us(ts_us, scene.quats_wxyz)
    ref_rate, ref_start = golden["varrate/gyro_params"]
    assert float(rate) == ref_rate
    np.testing.assert_allclose(float(new_ts[0]) / 1e6, ref_start, atol=0)


@pytest.mark.parametrize("name", list(SCENES))
def test_P_matrix_matches_reference(golden, name):
    scene, table, win = problem(name)
    F = SCENES[name]["n_frames"]
    for d in PROBE_DELAYS:
        P = compute_problem(table, win, _f32(d)).permute(1, 2, 0).numpy()  # (F, N, 3)
        for f in (0, F // 2, F - 2):
            ref = golden[f"{name}/P/f{f}/d{d}"]
            np.testing.assert_allclose(
                P[f, : ref.shape[0]], ref, atol=P_ATOL, err_msg=f"{name} frame {f} delay {d}")


@pytest.mark.parametrize("name", list(SCENES))
def test_frame_loss_matches_reference(golden, name):
    scene, table, win = problem(name)
    F = SCENES[name]["n_frames"]
    for d in (0.0, SCENES[name]["true_delay"]):
        for f in (0, F // 2):
            ref = golden[f"{name}/loss/f{f}/d{d}"]
            ref_simple = golden[f"{name}/loss_simple/f{f}/d{d}"][0]
            # full and simple overloads agree in the reference
            np.testing.assert_allclose(ref[0], ref_simple, rtol=1e-12)

            delay = _f32(d).requires_grad_(True)
            M = _f32(PROBE_M).requires_grad_(True)
            val = sync_mod.frame_loss(compute_problem(table, win, delay)[:, f], M, PROBE_VARK)
            dgrad, jm = torch.autograd.grad(val, (delay, M))
            np.testing.assert_allclose(float(val.detach()), ref[0], rtol=5e-4, atol=1e-6,
                                       err_msg=f"{name} f{f} d{d} loss")
            # the reference's delay gradient is a central difference
            # (step 1e-6) in f64; the port's is analytic f32
            np.testing.assert_allclose(
                float(dgrad), ref[1], rtol=2e-2, atol=5e-3 * abs(ref[1]) + 1e-2,
                err_msg=f"{name} f{f} d{d} delay grad")
            np.testing.assert_allclose(jm.numpy(), ref[2:], rtol=1e-3, atol=1e-4,
                                       err_msg=f"{name} f{f} d{d} motion jac")


@pytest.mark.parametrize("name", list(SCENES))
def test_spline_matches_reference(golden, name):
    scene, table, win = problem(name)
    ts = golden[f"{name}/spline/ts"]
    ref = golden[f"{name}/spline/vals"]  # (T, 4)
    i0 = torch.tensor(np.floor(ts), dtype=torch.int32)
    p = _f32(ts - np.floor(ts))
    got = eval_spline_packed(table.coeffs, i0, p).T.numpy()  # (T, 4)
    np.testing.assert_allclose(got, ref, atol=SPLINE_ATOL)


@pytest.mark.parametrize("name", list(SCENES))
def test_presync_matches_reference(golden, name):
    scene, table, win = problem(name)
    ref_cost, ref_delay = golden[f"{name}/presync"]
    delays = _f32(np.arange(-0.2, 0.2, 0.002))
    with torch.no_grad():
        costs = presync_mod.presync_scan(table, win, delays, _gen(0))
    _, best = presync_mod.presync_best(costs, delays)
    # the RANSAC draws differ between engines; the located coarse
    # minimum must agree to within two grid bins
    assert abs(float(best) - ref_delay) <= 0.004 + 1e-9, (best, ref_delay)

    ref_curve = golden[f"{name}/debug_presync/costs"]
    ref_dd = golden[f"{name}/debug_presync/delays"]
    with torch.no_grad():
        curve = presync_mod.presync_scan(table, win, _f32(ref_dd), _gen(1)).double().numpy()
    # same argmin neighborhood
    assert abs(int(np.argmin(curve)) - int(np.argmin(ref_curve))) <= 2
    # same loss-surface shape (RANSAC noise keeps it from being exact)
    a = (curve - curve.mean()) / curve.std()
    b = (ref_curve - ref_curve.mean()) / ref_curve.std()
    assert float(np.mean(a * b)) > 0.99


@pytest.mark.parametrize("name", list(SCENES))
def test_sync_matches_reference(golden, name):
    scene, table, win = problem(name)
    ref_finals = golden[f"{name}/sync_delays"]
    _, ref_presync_delay = golden[f"{name}/presync"]
    got = float(sync_passes(table, win, float(ref_presync_delay), "irls")[-1].delay)
    assert abs(got - ref_finals[-1]) < SYNC_REF_TOL_S, (got, ref_finals[-1])
    assert abs(got - SCENES[name]["true_delay"]) < SYNC_TRUTH_TOL_S


@pytest.mark.parametrize("name", list(SCENES))
def test_sync_trajectory_matches_reference(golden, name):
    """Per-iteration delay iterates of the reference's 4-pass Sync
    (captured from its stderr trace, core_private.cpp:330) against the
    port's in motion_opt="lbfgs" mode, both with ensmallen's strong-Wolfe
    line search. The trace has 6 significant digits and omits the final
    breaking iteration, hence the prefix comparison."""
    scene, table, win = problem(name)
    _, ref_presync_delay = golden[f"{name}/presync"]
    atol = trajectory_atol(name)
    for p, res in enumerate(sync_passes(table, win, float(ref_presync_delay), "lbfgs")):
        traj_ref = golden[f"{name}/sync_traj/p{p}"]
        n_it = int(res.iterations)
        assert abs(n_it - len(traj_ref)) <= 1, (n_it, len(traj_ref))
        m = min(len(traj_ref), n_it)
        if m:
            np.testing.assert_allclose(res.trace_delay[:m].numpy(), traj_ref[:m, 0], atol=atol,
                                       err_msg=f"{name} pass {p}")
            np.testing.assert_allclose(res.trace_step[:m].abs().numpy(), traj_ref[:m, 1],
                                       atol=atol, err_msg=f"{name} pass {p} steps")
