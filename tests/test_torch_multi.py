"""The port's multi-clip sync (rssync_tpu_torch/parallel/multi.py), its
batched spline tables (core/problem.py), guess-orient
(pipeline/guess_orient.py) and run_multi_recipes, held to rssync_tpu's
on the same inputs: scenes of tests/synthetic.py::make_scene (the cases
of tests/test_multi_clip.py) and rendered clips of rssync_tpu's
make_clip (the cases of tests/test_pipeline.py), on the CPU.

Delays agree with rssync_tpu's within 0.1 ms (float32 optimizations of
the same loss from different RANSAC draws) and with the truth within
0.5 ms; spline coefficients within 1e-6.
"""

import json

import numpy as np
import pytest
import torch

from rssync_tpu_torch.core.api import SyncProblem
from rssync_tpu_torch.core.problem import (
    compute_problem,
    make_spline_table,
    make_spline_tables_batched,
)
from rssync_tpu_torch.core.ransac import sample_pairs
from rssync_tpu_torch.core.presync import PRESYNC_RANSAC_ITERS, presync_grid
from rssync_tpu_torch.parallel import multi as M
from rssync_tpu_torch.parallel.batch import batched_presync, stack_windows
from rssync_tpu_torch.pipeline import recipe as R

torch.set_num_threads(2)

TRUTH_TOL_S, JAX_TOL_S = 5e-4, 1e-4
COEFF_ATOL = 1e-6


def _quats(seed, V, n):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(V, n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_make_spline_tables_batched_matches_jax():
    pytest.importorskip("jax")
    from rssync_tpu.core.problem import make_spline_tables_batched as jbatched

    q = _quats(0, 5, 37)
    got = make_spline_tables_batched(q, 200.0, device="cpu")
    want = jbatched(q, 200.0)
    assert got.coeffs.shape == (5, 16, 37) and got.sample_rate.shape == (5,)
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(want.coeffs), rtol=0,
                               atol=COEFF_ATOL)
    np.testing.assert_array_equal(got.sample_rate.numpy(), np.asarray(want.sample_rate))
    for v in range(5):  # one solve over 4V rows == V separate fits
        np.testing.assert_allclose(got.coeffs[v].numpy(),
                                   make_spline_table(q[v], 200.0, device="cpu").coeffs.numpy(),
                                   rtol=0, atol=COEFF_ATOL)


def test_stack_tables_matches_jax_padding():
    pytest.importorskip("jax")
    from rssync_tpu.core.problem import make_spline_table as jtable
    from rssync_tpu.parallel.multi import stack_tables as jstack

    qs = [_quats(1, 1, 30)[0], _quats(2, 1, 41)[0]]
    got = M.stack_tables([make_spline_table(q, 200.0, device="cpu") for q in qs])
    want = jstack([jtable(q, 200.0) for q in qs])
    assert got.coeffs.shape == (2, 16, 41)
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(want.coeffs), rtol=0,
                               atol=COEFF_ATOL)
    # the edge-replicated columns are exact copies of the last knot's
    assert torch.equal(got.coeffs[0, :, 30:], got.coeffs[0, :, 29:30].expand(-1, 11))
    np.testing.assert_array_equal(got.sample_rate.numpy(), np.asarray(want.sample_rate))


# ---------------------------------------------------------------------------
# tests/test_multi_clip.py's scenes


def _scene_problem(seed, true_delay, n_frames=12, pad_extra=0.0):
    from synthetic import make_scene

    scene = make_scene(seed=seed, true_delay=true_delay, n_frames=n_frames, n_points=40,
                       duration_pad=3.0 + pad_extra)
    sp = SyncProblem(seed=seed, device="cpu")
    sp.set_gyro_quaternions(scene.quats_wxyz, scene.gyro_rate, float(scene.gyro_ts[0]))
    for f, d in scene.frames.items():
        sp.set_track_result(f, *d)
    return sp, scene


def _jax_problem(seed, scene):
    import rssync_tpu

    sp = rssync_tpu.create_sync_problem(seed=seed)
    sp.set_gyro_quaternions(scene.quats_wxyz, scene.gyro_rate, float(scene.gyro_ts[0]))
    for f, d in scene.frames.items():
        sp.set_track_result(f, *d)
    return sp


def test_per_window_tables_equal_each_windows_own():
    """compute_problem over a stack of (padded) per-window tables gives
    each window exactly what its own table gives it, at (K, W) delays."""
    sp1, _ = _scene_problem(21, 0.0123)
    sp2, _ = _scene_problem(22, -0.0312, pad_extra=0.7)
    wins = [sp1.build_window(0, 5), sp2.build_window(2, 7)]
    tables = [sp1.spline_table, sp2.spline_table]
    assert tables[0].n_knots != tables[1].n_knots
    t_stack, w_stack = M.stack_problems(tables, wins, 0.1)
    d = torch.tensor([[0.01, -0.02], [0.0, 0.03]])
    P = compute_problem(t_stack, w_stack, d)  # (K, W, 3, F, N)
    for w in range(2):
        for k in range(2):
            want = compute_problem(tables[w], wins[w], d[k, w])
            F, N = want.shape[-2:]
            assert torch.equal(P[k, w, :, :F, :N], want)


@pytest.mark.parametrize("per_window_grid", [False, True])
def test_batched_presync_multi_equals_per_clip_presync(per_window_grid):
    """With the same injected RANSAC pairs, the stacked multi-clip
    PreSync finds each window's best delay where a per-clip
    batched_presync does, at the same cost."""
    sp1, _ = _scene_problem(21, 0.0123)
    sp2, _ = _scene_problem(22, -0.0312, pad_extra=0.7)
    clips = [(sp1, [0, 4], 5), (sp2, [2], 6)]
    grids = [presync_grid(0.0, 0.05, 0.002), presync_grid(-0.03, 0.04, 0.004)]
    if not per_window_grid:
        grids = [grids[0], grids[0]]
    tables, wins, owners = [], [], []
    for ci, (sp, pts, n) in enumerate(clips):
        for p in pts:
            tables.append(sp.spline_table)
            wins.append(sp.build_window(p, p + n))
            owners.append(ci)
    t_stack, w_stack = M.stack_problems(tables, wins, 0.1)
    D = max(len(g) for g in grids)
    if per_window_grid:
        delays = torch.full((len(owners), D), float("inf"))
        for w, ci in enumerate(owners):
            delays[w, : len(grids[ci])] = torch.tensor(grids[ci])
    else:
        delays = torch.tensor(grids[0])
    pairs = sample_pairs(torch.Generator().manual_seed(3), PRESYNC_RANSAC_ITERS,
                         w_stack.counts.expand(D, *w_stack.counts.shape))
    cost, best = batched_presync(t_stack, w_stack, delays, None, pairs=pairs)
    for ci, (sp, pts, n) in enumerate(clips):
        ws = [w for w, c in enumerate(owners) if c == ci]
        g = torch.tensor(grids[ci])
        F = max(wins[w].num_frames for w in ws)
        clip_pairs = tuple(r[: len(g), ws, :F] for r in pairs)
        c_cost, c_best = batched_presync(sp.spline_table, stack_windows([wins[w] for w in ws]),
                                         g, None, pairs=clip_pairs)
        assert torch.equal(best[ws], c_best)
        torch.testing.assert_close(cost[ws], c_cost, rtol=1e-5, atol=0)


def _sync_clips_case(case):
    if case == "homogeneous":
        scenes = [(21, 0.0123, 0.0), (22, -0.0312, 0.7)]
        kw = dict(sync_window_frames=5, initial_delay=0.0, presync_step=0.002,
                  presync_radius=0.08)
        return scenes, [[0, 4], [2, 6]], kw
    scenes = [(41, 0.0123, 0.0), (42, -0.0912, 0.7)]
    kw = dict(sync_window_frames=[5, 6], initial_delay=[0.0, -0.08],
              presync_step=[0.002, 0.004], presync_radius=[0.05, 0.04])
    return scenes, [[0, 4], [2]], kw


@pytest.mark.parametrize("case", ["homogeneous", "heterogeneous"])
def test_sync_clips_matches_jax(case):
    """tests/test_multi_clip.py's two cases: clips with different gyro
    tables (knot counts), delays and, in the second, per-clip windows,
    guesses and PreSync grids, through the port and rssync_tpu."""
    jax = pytest.importorskip("jax")
    from rssync_tpu.parallel.multi import sync_clips as jsync_clips

    scenes, pts, kw = _sync_clips_case(case)
    made = [_scene_problem(s, d, pad_extra=p) for s, d, p in scenes]
    got = M.sync_clips([sp for sp, _ in made], pts, generator=torch.Generator().manual_seed(0),
                       **kw)
    want = jsync_clips([_jax_problem(s, sc) for (s, _, _), (_, sc) in zip(scenes, made)], pts,
                       key=jax.random.PRNGKey(0), **kw)
    assert [len(x) for x in got] == [len(p) for p in pts]
    for g, w, (_, sc) in zip(got, want, made):
        assert np.abs(np.asarray(g) - sc.true_delay).max() < TRUTH_TOL_S
        assert np.abs(np.asarray(g) - np.asarray(w)).max() < JAX_TOL_S


def test_sync_clips_all_empty_schedules():
    """Every clip's schedule empty: per-clip empty results, nothing
    stacked (test_edgecases.py:152)."""
    sp, _ = _scene_problem(21, 0.0123)
    assert M.sync_clips([sp, sp], [[], []], 60, 0.0, 0.002, 0.05,
                        torch.Generator().manual_seed(0)) == [[], []]


def test_stack_problems_refuses_non_interior_windows():
    sp1, _ = _scene_problem(21, 0.0123)
    sp2, _ = _scene_problem(22, -0.0312, pad_extra=0.7)
    wins = [sp1.build_window(0, 5), sp2.build_window(2, 7)]
    with pytest.raises(ValueError, match="interior"):
        M.stack_problems([sp1.spline_table, sp2.spline_table], wins, delay_margin_s=5.0)


# ---------------------------------------------------------------------------
# guess-orient and run_multi_recipes on rendered clips


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """tests/test_pipeline.py's two clips (640x480, 26 frames, 30 fps)."""
    pytest.importorskip("jax")
    from rssync_tpu.testing.synthvideo import make_clip

    return [make_clip(str(tmp_path_factory.mktemp(f"clip{seed}")), seed=seed, true_delay=d,
                      n_frames=26, fps=30.0, width=640, height=480, pad=1.0)
            for seed, d in ((2, 0.0213), (9, -0.0117))]


def make_recipe(clip, out_dir, name="sync", **over):
    r = {
        "input": {
            "video_path": clip.video_path, "gyro_path": clip.gyro_path,
            "gyro_orientation": clip.orient, "frame_range": [0, 25],
            "lens_profile": {"type": "file", "path": clip.lens_path, "name": clip.lens_name},
            "initial_guess": 500.0, "use_simple_presync": True,
            "simple_presync_radius": 80.0, "simple_presync_step": 2.0,
        },
        "params": {"sync_window": 8, "syncpoints_format": "auto", "syncpoint_distance": 8},
        "output": {"csv_path": str(out_dir / f"{name}.csv"), "debug_csv_path": ""},
    }
    for k, v in over.items():
        sec, key = k.split("__")
        r[sec][key] = v
    return r


def test_guess_orient_ranks_truth_first_as_jax(clips, tmp_path):
    """All 48 orientations over frames (0, 12): the clip's own ranks
    first, clearly ahead of the runner-up (test_pipeline.py:144), and
    rssync_tpu ranks the same one first."""
    from rssync_tpu.pipeline.guess_orient import run_guess_orient as jrun
    from rssync_tpu_torch.pipeline.guess_orient import all_orientations, run_guess_orient

    recipe = make_recipe(clips[0], tmp_path)
    got = run_guess_orient(recipe, frames=(0, 12), device="cpu")
    assert sorted(o for _, _, o in got) == sorted(all_orientations()) and len(got) == 48
    assert got[0][2] == clips[0].orient
    assert got[0][0] < got[1][0] * 0.9
    assert jrun(recipe, frames=(0, 12))[0][2] == got[0][2]


def test_multi_recipes_match_truth_and_single_runs(clips, tmp_path):
    """Two clips as one batched run through the CLI (--multi): each
    clip's delays within 0.5 ms of its truth, CSVs written; then
    heterogeneous settings on one clip (test_pipeline.py:182), and a
    recipe without simple PreSync refused."""
    from rssync_tpu_torch.pipeline.__main__ import main

    paths = []
    for i, c in enumerate(clips):
        p = tmp_path / f"r{i}.json"
        p.write_text(json.dumps(make_recipe(c, tmp_path, name=f"c{i}")))
        paths.append(str(p))
    cache = str(tmp_path / "cache")
    assert main(paths + ["--multi", "--device", "cpu", "--quiet", "--track-cache", cache]) == 0
    for i, c in enumerate(clips):
        rows = np.loadtxt(tmp_path / f"c{i}.csv", delimiter=",", ndmin=2)
        np.testing.assert_array_equal(rows[:, 0], [0, 8, 16])
        assert np.abs(rows[:, 1] - 1000.0 * c.true_delay).max() < 1000 * TRUTH_TOL_S

    r1 = make_recipe(clips[0], tmp_path)
    r2 = make_recipe(clips[0], tmp_path, params__sync_window=10,
                     input__simple_presync_radius=60.0, input__simple_presync_step=4.0)
    res = R.run_multi_recipes([r1, r2], track_cache_dir=cache, device="cpu")
    assert [r.syncpoints for r in res] == [[0, 8, 16], [0, 8]]
    for r in res:
        assert np.abs(np.asarray(r.delays_ms) - 1000.0 * clips[0].true_delay).max() \
            < 1000 * TRUTH_TOL_S

    # rssync_tpu's run_multi_recipes on the same two recipes, its tracks
    # from the port's cache (the same key, file name and format): the
    # same recipes through the other engine
    from rssync_tpu.pipeline.recipe import run_multi_recipes as jrun_multi

    cached = sorted(p.name for p in (tmp_path / "cache").iterdir())
    jr = [make_recipe(clips[0], tmp_path, name="j1"),
          make_recipe(clips[0], tmp_path, name="j2", params__sync_window=10,
                      input__simple_presync_radius=60.0, input__simple_presync_step=4.0)]
    want = jrun_multi(jr, track_cache_dir=cache)
    assert sorted(p.name for p in (tmp_path / "cache").iterdir()) == cached
    assert [w.syncpoints for w in want] == [r.syncpoints for r in res]
    for r, w in zip(res, want):
        assert np.abs(np.asarray(r.delays_ms) - np.asarray(w.delays_ms)).max() \
            < 1000 * JAX_TOL_S
    with pytest.raises(ValueError, match="use_simple_presync"):
        R.run_multi_recipes([r1, make_recipe(clips[0], tmp_path,
                                             input__use_simple_presync=False)], device="cpu")
