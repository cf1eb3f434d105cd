"""The port's window-axis sharding (rssync_tpu_torch/parallel/mesh.py) and
batched_sync_pipeline (parallel/batch.py) on the CPU, with meshes of 1, 2
and 4 CPU shards (one device named several times: the shards run in
order on one worker thread).

The cases are tests/test_sharding.py's (make_scene seed 9, 16 frames,
40 points, 4 windows) and tests/test_multi_clip.py's sharded fleet.
Every RANSAC pair is drawn for the whole batch before the split, so a
sharded run is bit-equal (`torch.equal`) to the unsharded one. Against
rssync_tpu, whose draws differ: PreSync best delays within one grid
step (test_sharding.py's limit), Sync delays within 0.1 ms, and the
truth within 1 ms (test_sharding.py's) or 0.5 ms (the pipeline).
"""

import numpy as np
import pytest
import torch

from rssync_tpu_torch.core.problem import build_track_window, make_spline_table
from rssync_tpu_torch.parallel import batch as B
from rssync_tpu_torch.parallel import mesh as M
from rssync_tpu_torch.parallel.multi import stack_problems

torch.set_num_threads(2)

SHARDS = [1, 2, 4]
GRID_STEP_S = 0.002
JAX_SYNC_TOL_S, TRUTH_TOL_S, PIPELINE_TRUTH_TOL_S = 1e-4, 1e-3, 5e-4


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _cpu_mesh(n):
    return M.make_mesh(["cpu"] * n)


def _results_equal(a, b) -> bool:
    """Every field of two SyncResults bit-equal (NaN trace tails equal)."""
    return all(x.shape == y.shape and x.dtype == y.dtype
               and torch.equal(torch.nan_to_num(x, nan=-7.0), torch.nan_to_num(y, nan=-7.0))
               and torch.equal(torch.isnan(x), torch.isnan(y))
               for x, y in zip(a, b))


@pytest.fixture(scope="module")
def batch_problem():
    from synthetic import make_scene

    scene = make_scene(seed=9, true_delay=0.011, n_frames=16, n_points=40)
    table = make_spline_table(scene.quats_wxyz, scene.gyro_rate, device="cpu")
    frames = sorted(scene.frames)

    def win(f0, f1):
        sel = [f for f in frames if f0 <= f <= f1]
        return build_track_window(*[[scene.frames[f][k] for f in sel] for k in range(4)],
                                  quats_start=float(scene.gyro_ts[0]),
                                  sample_rate=scene.gyro_rate, device="cpu")

    spans = [(0, 3), (4, 7), (8, 11), (12, 15)]
    wins = B.stack_windows([win(*s) for s in spans])
    return scene, table, wins, spans


@pytest.fixture(scope="module")
def jax_batch(batch_problem):
    """test_sharding.py's JAX batch on the same scene."""
    pytest.importorskip("jax")
    from rssync_tpu.core.problem import build_track_window as jwin
    from rssync_tpu.core.problem import make_spline_table as jtable
    from rssync_tpu.parallel import batch as JB

    scene, _, _, spans = batch_problem
    frames = sorted(scene.frames)

    def win(f0, f1):
        sel = [f for f in frames if f0 <= f <= f1]
        return jwin(*[[scene.frames[f][k] for f in sel] for k in range(4)],
                    quats_start=float(scene.gyro_ts[0]), sample_rate=scene.gyro_rate)

    return JB, jtable(scene.quats_wxyz, scene.gyro_rate), JB.stack_windows(
        [win(*s) for s in spans])


def _grid():
    return torch.tensor(np.arange(-0.05, 0.05, GRID_STEP_S), dtype=torch.float32)


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_presync_bit_equal_to_unsharded(batch_problem, n):
    _, table, wins, _ = batch_problem
    cost_u, best_u = B.batched_presync(table, wins, _grid(), _gen(3))
    cost_s, best_s = M.sharded_presync(table, wins, _grid(), _gen(3), _cpu_mesh(n))
    assert torch.equal(best_s, best_u)
    assert torch.equal(cost_s, cost_u)
    # shards placed beforehand give the same
    mesh = _cpu_mesh(n)
    placed = M.sharded_presync(M.replicate_table(table, mesh), M.shard_windows(wins, mesh),
                               _grid(), _gen(3), mesh)
    assert torch.equal(placed[1], best_u) and torch.equal(placed[0], cost_u)


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_sync_bit_equal_to_unsharded(batch_problem, n):
    scene, table, wins, _ = batch_problem
    init = torch.full((4,), scene.true_delay + 0.003)
    res_u = B.batched_sync(table, wins, init, init, 0.2, _gen(5))
    mesh = _cpu_mesh(n)
    res_s = M.sharded_sync(table, wins, M.shard_vector(init, mesh), init, 0.2, _gen(5), mesh)
    assert torch.equal(res_s.delay, res_u.delay)
    assert _results_equal(res_s, res_u)
    err = (res_s.delay.double() - scene.true_delay).abs()
    assert float(err.max()) < TRUTH_TOL_S


def test_unsharded_presync_and_sync_match_jax(batch_problem, jax_batch):
    import jax
    import jax.numpy as jnp

    scene, table, wins, _ = batch_problem
    JB, jtable, jwins = jax_batch
    _, best = B.batched_presync(table, wins, _grid(), _gen(3))
    _, jbest = JB.batched_presync(jtable, jwins, jnp.asarray(_grid().numpy()),
                                  jax.random.PRNGKey(3))
    np.testing.assert_allclose(best.numpy(), np.asarray(jbest), rtol=0,
                               atol=GRID_STEP_S + 1e-9)
    assert float((best.double() - scene.true_delay).abs().max()) < 0.004

    init = torch.full((4,), scene.true_delay + 0.003)
    res = M.sharded_sync(table, wins, init, init, 0.2, _gen(5), _cpu_mesh(2))
    jinit = jnp.full((4,), scene.true_delay + 0.003, jnp.float32)
    jres = JB.batched_sync(jtable, jwins, jinit, jinit, 0.2, jax.random.PRNGKey(5))
    np.testing.assert_allclose(res.delay.numpy(), np.asarray(jres.delay), rtol=0,
                               atol=JAX_SYNC_TOL_S)


def test_pad_to_multiple_and_padded_sharded_run(batch_problem):
    scene, table, wins, _ = batch_problem
    padded, orig = M.pad_to_multiple(wins, 8)
    assert orig == 4 and padded.frame_mask.shape[0] == 8
    for name in B.TrackWindow.__dataclass_fields__:
        x = getattr(padded, name)
        assert torch.equal(x[:4], getattr(wins, name))
        assert not x[4:].any(), name
    same, w = M.pad_to_multiple(wins, 2)
    assert same is wins and w == 4
    with pytest.raises(ValueError, match="pad_to_multiple"):
        M.shard_windows(wins, _cpu_mesh(3))
    # the padded batch draws its pairs over 8 windows, so it is held to
    # its own unsharded run; the padding scores zero and moves nothing
    mesh = _cpu_mesh(4)
    cost_u, best_u = B.batched_presync(table, padded, _grid(), _gen(3))
    cost_s, best_s = M.sharded_presync(table, padded, _grid(), _gen(3), mesh)
    assert torch.equal(best_s, best_u) and torch.equal(cost_s, cost_u)
    assert not cost_s[4:].any()
    init = torch.full((8,), scene.true_delay + 0.003)
    res_u = B.batched_sync(table, padded, init, init, 0.2, _gen(5))
    res_s = M.sharded_sync(table, padded, init, init, 0.2, _gen(5), mesh)
    assert _results_equal(res_s, res_u)
    assert torch.equal(res_s.delay[4:], init[4:])  # empty windows stay put
    assert float((res_s.delay[:4].double() - scene.true_delay).abs().max()) < TRUTH_TOL_S


def test_multi_clip_fleet_sharded_four_ways():
    """tests/test_multi_clip.py:58: two clips with different tables and
    delays, four windows over a stacked table sharded like them."""
    from test_torch_multi import _scene_problem

    sp1, sc1 = _scene_problem(31, 0.02)
    sp2, sc2 = _scene_problem(32, -0.015, pad_extra=0.4)
    tables, wins = stack_problems(
        [sp1.spline_table, sp1.spline_table, sp2.spline_table, sp2.spline_table],
        [sp1.build_window(0, 5, closed=True), sp1.build_window(4, 9, closed=True),
         sp2.build_window(0, 5, closed=True), sp2.build_window(4, 9, closed=True)],
    )
    truth = torch.tensor([sc1.true_delay, sc1.true_delay, sc2.true_delay, sc2.true_delay])
    init = truth + 0.003
    mesh = _cpu_mesh(4)
    shards = M.replicate_table(tables, mesh)
    assert [t.coeffs.shape[0] for t in shards] == [1, 1, 1, 1]
    res_u = B.batched_sync(tables, wins, init, init, 0.1, _gen(5))
    res_s = M.sharded_sync(shards, M.shard_windows(wins, mesh), init, init, 0.1, _gen(5), mesh)
    assert _results_equal(res_s, res_u)
    assert float((res_s.delay.double() - truth.double()).abs().max()) < TRUTH_TOL_S
    grids = torch.tensor(np.arange(-0.05, 0.05, GRID_STEP_S), dtype=torch.float32)
    grids = (grids[None] + truth[:, None]).contiguous()  # per-window (W, D) grids
    best_u = B.batched_presync(tables, wins, grids, _gen(2), centers=truth)
    best_s = M.sharded_presync(tables, wins, grids, _gen(2), mesh, centers=truth)
    assert torch.equal(best_s[1], best_u[1]) and torch.equal(best_s[0], best_u[0])


def test_make_mesh_devices(monkeypatch):
    mesh = M.make_mesh(["cpu", "cpu", "cpu"])
    assert mesh.size == 3 and mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.axis_name == M.WINDOW_AXIS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh()
    with pytest.raises(ValueError):
        M.make_mesh([])


def test_batched_sync_pipeline_equals_separate_calls(batch_problem):
    """test_sharding.py:86's property: the pipeline is PreSync plus 4
    Sync passes centered on the initial delay, drawing from the one
    generator in turn."""
    scene, table, wins, _ = batch_problem
    delays = torch.tensor(np.linspace(-0.05, 0.05, 21), dtype=torch.float32)
    best_f, results = B.batched_sync_pipeline(table, wins, wins, delays, 0.0, 0.1, _gen(7),
                                              passes=4)
    gen = _gen(7)
    _, best_s = B.batched_presync(table, wins, delays, gen)
    centers = torch.zeros(4)
    cur, separate = best_s, []
    for _ in range(4):
        separate.append(B.batched_sync(table, wins, cur, centers, 0.1, gen))
        cur = separate[-1].delay
    assert torch.equal(best_f, best_s)
    assert len(results) == 4
    for a, b in zip(results, separate):
        assert _results_equal(a, b)
    err = (results[-1].delay.double() - scene.true_delay).abs()
    assert float(err.max()) < PIPELINE_TRUTH_TOL_S
