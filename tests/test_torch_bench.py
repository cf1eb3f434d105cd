"""The port's headline benchmark (rssync_tpu_torch/testing/bench.py) held,
stage by stage, to the JAX functions bench.py calls, on the same
numpy-seeded inputs at the bench's small size; and the bench as a whole
on the CPU (plain versions, untimed)."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from rssync_tpu.frontend import tracking as jtracking
from rssync_tpu.parallel import batch as jbatch
from rssync_tpu.testing import texture_scene as jtex
from rssync_tpu.testing.engine_problem import make_engine_problem as jmake
from rssync_tpu_torch.testing import bench

torch.set_num_threads(2)

SIZE = bench.SMALL
#: tracked positions: float32 Gauss-Newton steps whose sums and small
#: matmuls reduce in another order than XLA's (test_torch_tracking.py's)
TRACK_ATOL = 2e-3
#: on-video median and p95 error against rssync_tpu's, px
ONVIDEO_ATOL_PX = 1e-3
#: delays: the engine's accuracy target, and the agreement with
#: rssync_tpu (float32 optimizations of the same loss from different
#: RANSAC draws; test_torch_engine.py's)
TRUTH_TOL_MS, JAX_TOL_MS = 0.5, 0.1


@pytest.fixture(scope="module")
def small_run():
    return bench.run(device="cpu", small=True)


def test_sizes_are_bench_py_s():
    """FULL is bench.py's workload: 15 x 240 = 3600 pairs of 2704x2028
    stored 2816x2056, 130 points, 49 textured frames, the 30-window
    engine problem and a 200-delay grid."""
    F = bench.FULL
    assert (F.height, F.width, F.dispatches * F.seg, F.chunk) == (2028, 2704, 3600, 16)
    assert bench.stored_dims(F.height, F.width) == (2056, 2816)
    assert len(bench.grid_points(F.width, F.height, F.grid_step)) == 130
    assert (F.tex_frames, F.tex_height, F.tex_width) == (49, 2028, 2704)
    prob = bench.make_engine_problem(**F.engine)
    assert len(prob.syncpoints) == 30 and prob.true_delay == 0.0423
    assert len(bench.delay_grid("cpu")) == 200


def test_tracking_stage_matches_jax():
    H, W = SIZE.height, SIZE.width
    frames = np.random.default_rng(0).integers(
        0, 255, (SIZE.seg + 1, *bench.stored_dims(H, W)), np.uint8)
    got = bench.track(torch.from_numpy(frames), SIZE)
    want = np.asarray(jtracking.lk_track_video_chunked(
        jnp.asarray(frames), chunk=SIZE.chunk, grid_step=SIZE.grid_step, logical_hw=(H, W)))
    assert got.shape == want.shape == (SIZE.seg, 12, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=TRACK_ATOL)


def test_onvideo_stage_matches_jax(small_run):
    """The bench's accuracy stage against the same computation through
    rssync_tpu: its render, tracker and error."""
    H, W = SIZE.tex_height, SIZE.tex_width
    got = (small_run["extras"]["onvideo_track_med_px"],
           small_run["extras"]["onvideo_track_p95_px"])
    frames, affines = jtex.render_scene(bench.TEX_SEED, SIZE.tex_frames, H, W, cache_dir=None)
    tracked = np.asarray(jtracking.lk_track_video_chunked(
        jnp.asarray(jtracking.pad_frames_host(frames)),
        chunk=math.gcd(SIZE.chunk, SIZE.tex_frames - 1), grid_step=SIZE.tex_grid_step,
        logical_hw=(H, W)))
    pts = np.asarray(jtracking.grid_points(W, H, SIZE.tex_grid_step), np.float64)
    want = jtex.tracking_error(tracked, pts, affines, W, H)
    np.testing.assert_allclose(got, want, atol=ONVIDEO_ATOL_PX)
    assert got[0] <= bench.TEX_MED_PX and got[1] <= bench.TEX_P95_PX


def test_engine_stage_matches_jax():
    prob = bench.make_engine_problem(**SIZE.engine)
    got = bench.engine_rep(prob.table("cpu"), bench.stack_windows(prob.windows("cpu")),
                           bench.delay_grid("cpu"), 0)[0].double().numpy()
    jp = jmake(**SIZE.engine)
    wins = jbatch.stack_windows(jp.windows)
    delays = jnp.asarray(np.arange(-0.2, 0.2, 0.002), jnp.float32)
    _, best = jbatch.batched_presync(jp.table, wins, delays, jax.random.PRNGKey(10))
    cur = best
    for i in range(bench.SYNC_PASSES):
        cur = jbatch.batched_sync(jp.table, wins, cur, best, bench.SYNC_RADIUS,
                                  jax.random.PRNGKey(20 + i)).delay
    want = np.asarray(cur, np.float64)
    assert got.shape == want.shape == (3,)
    assert np.abs(got - prob.true_delay).max() * 1e3 < TRUTH_TOL_MS
    assert np.abs(got - want).max() * 1e3 < JAX_TOL_MS


def test_run_on_cpu_small(small_run):
    """Every key of the result line; nothing timed, no kernel launched,
    every check held."""
    out = small_run
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "extras"}
    ex = out["extras"]
    assert set(ex) == {
        "track_s", "presync_s", "sync4x_s", "offset_err_ms", "onvideo_track_med_px",
        "onvideo_track_p95_px", "ms_per_pair", "kernels", "card", "peak_mem_gib", "failed"}
    timed = ("track_s", "presync_s", "sync4x_s", "ms_per_pair", "card", "peak_mem_gib")
    assert out["value"] is None and out["vs_baseline"] is None
    assert all(ex[k] is None for k in timed)
    assert set(ex["kernels"]) == {"score_quartile_batched", "gather_strips"}
    for k in ex["kernels"].values():
        assert k["launches"] == 0 and k["shapes"] == [] and set(k["by_stage"].values()) == {0}
    assert ex["offset_err_ms"] < TRUTH_TOL_MS
    assert ex["failed"] == []


def test_kernel_report_reads_counters_by_stage(monkeypatch):
    """Launches in all and by stage from the counters read after each
    stage; every launch shape compared (here the wrappers take their
    plain versions: the inputs at each shape are what is tested); K1
    listed only where launched."""
    monkeypatch.setitem(bench.S.LAUNCH_SHAPES, "score_quartile_batched", {(6, 10, 40, 20)})
    monkeypatch.setitem(bench.ST.LAUNCH_SHAPES, "gather_strips", {
        (4, 64, 256, 4, 5, "torch.uint8"), (9, 64, 256, 4, 5, "torch.float32")})
    counts = dict(score_quartile=0, score_quartile_batched=0, gather_strips=0)
    stages = {"track": dict(counts, gather_strips=30), "onvideo": dict(counts, gather_strips=36),
              "engine": dict(counts, score_quartile_batched=5, gather_strips=36)}
    got = bench.kernel_report(stages, "cpu")
    assert set(got) == {"score_quartile_batched", "gather_strips"}
    k3 = got["gather_strips"]
    assert k3["launches"] == 36 and k3["by_stage"] == {"track": 30, "onvideo": 6, "engine": 0}
    assert [r["shape"] for r in k3["shapes"]] == [
        [4, 64, 256, 4, 5, "torch.uint8"], [9, 64, 256, 4, 5, "torch.float32"]]
    assert got["score_quartile_batched"]["by_stage"]["engine"] == 5
    assert all(k["bit_equal"] for k in got.values())
    stages["engine"]["score_quartile"] = 2
    monkeypatch.setitem(bench.S.LAUNCH_SHAPES, "score_quartile", {(1, 12, 40, 200)})
    assert bench.kernel_report(stages, "cpu")["score_quartile"]["launches"] == 2


def test_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() == 1
    assert capsys.readouterr().out == ""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run()
