"""Parity of the port's engine modules (problem, RANSAC, PreSync cost,
Sync loss and motion refinement) with rssync_tpu's on identical inputs:
the JAX tables and windows are handed to the port as numpy leaves."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rssync_tpu.core import presync as jpresync
from rssync_tpu.core import problem as jproblem
from rssync_tpu.core import ransac as jransac
from rssync_tpu.core import sync as jsync
from rssync_tpu.testing.engine_problem import make_engine_problem as jmake
from rssync_tpu_torch.core import presync as tpresync
from rssync_tpu_torch.core import problem as tproblem
from rssync_tpu_torch.core import ransac as transac
from rssync_tpu_torch.core import sync as tsync
from rssync_tpu_torch.parallel.batch import stack_windows
from rssync_tpu_torch.testing.engine_problem import make_engine_problem as tmake

torch.set_num_threads(2)

CPU = torch.device("cpu")
#: a gyro log only 0.05 s longer than the clip at each end, so delays of
#: +-0.15 s evaluate the spline below knot 0 and past the last knot
SCENE = dict(seed=4, duration=2.0, fps=30.0, n_features=24, sync_window=10,
             syncpoint_distance=49, pad=0.05)
#: delays that put rays below knot 0 (first window), in the last
#: segment and past the last knot (last window), and the truth
DELAYS = [-0.15, -0.04, 0.0423, 0.07, 0.15]
#: float32 evaluation of the same formulas; only rounding and the
#: order of short sums differ between the frameworks
RTOL, ATOL = 1e-5, 1e-6

jcompute = jax.jit(jproblem.compute_problem)


@pytest.fixture(scope="module")
def scenes():
    """(JAX problem, port table, port windows) on identical arrays."""
    jp = jmake(**SCENE)
    table = tproblem.table_from_numpy(
        np.asarray(jp.table.coeffs), np.asarray(jp.table.sample_rate), device=CPU)
    wins = [_port_window(w) for w in jp.windows]
    return jp, table, wins


def _port_window(w):
    return tproblem.window_from_numpy(
        *(np.asarray(getattr(w, f)) for f in (
            "rays_a", "rays_b", "i0_a", "i0_b", "f0_a", "f0_b",
            "feat_mask", "frame_mask", "counts")),
        device=CPU,
    )


def test_table_and_windows_equal_jax():
    """make_spline_table / build_track_window build the same numbers:
    ints exactly, floats to the bit."""
    jp = jmake(**SCENE)
    tp = tmake(**SCENE)
    np.testing.assert_array_equal(tp.table(CPU).coeffs.numpy(), np.asarray(jp.table.coeffs))
    assert float(tp.table(CPU).sample_rate) == float(jp.table.sample_rate)
    for jw, tw in zip(jp.windows, tp.windows(CPU)):
        for name in ("rays_a", "rays_b", "i0_a", "i0_b", "f0_a", "f0_b",
                     "feat_mask", "frame_mask", "counts"):
            a, b = getattr(tw, name).numpy(), np.asarray(getattr(jw, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_build_track_window_refuses_wide_span():
    ts = np.asarray([0.0, 0.2])  # 40 knots at 200 Hz in one frame
    rays = np.asarray([[0.0, 0.0, 1.0]] * 2)
    with pytest.raises(ValueError, match="knot span"):
        tproblem.build_track_window([ts], [ts], [rays], [rays], 0.0, 200.0, device=CPU)


@pytest.mark.parametrize("wi", [0, 1])  # the first and the last window
def test_compute_problem_matches_jax_narrow_and_wide(scenes, wi):
    jp, table, wins = scenes
    jw = jp.windows[wi]
    bands = jproblem.make_wide_bands(jp.table, jw, jnp.float32(0.0))
    for d in DELAYS:
        got = tproblem.compute_problem(table, wins[wi], torch.tensor(d)).numpy()
        narrow = np.array(jcompute(jp.table, jw, jnp.float32(d)))
        wide = np.array(jcompute(jp.table, jw, jnp.float32(d), bands))
        np.testing.assert_allclose(got, narrow, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, wide, rtol=RTOL, atol=ATOL)
    # the delay axis broadcasts: all delays at once give the same rows
    many = tproblem.compute_problem(table, wins[wi], torch.tensor(DELAYS))
    for k, d in enumerate(DELAYS):
        torch.testing.assert_close(
            many[k], tproblem.compute_problem(table, wins[wi], torch.tensor(d)),
            rtol=0, atol=0)


def _pairs(rng, counts, iters):
    c = np.maximum(counts, 2)[:, None]
    r0 = rng.integers(0, c, size=(len(counts), iters))
    r1 = rng.integers(0, c - 1, size=(len(counts), iters))
    return r0, r1 + (r1 >= r0)


def test_guess_motion_rows_with_injected_pairs(scenes):
    """Same pairs in, same winning directions out (K1's caller)."""
    jp, table, wins = scenes
    P = np.array(jcompute(jp.table, jp.windows[0], jnp.float32(0.01)))
    counts = np.array(jp.windows[0].counts)
    counts[2] = 1  # degenerate rows fall back to +z in both
    counts[3] = 0
    P[:, 3] = 0.0
    P[:, 2, 1:] = 0.0
    r0, r1 = _pairs(np.random.default_rng(0), counts, 64)
    want = np.asarray(jax.jit(jransac.guess_motion_rows, static_argnums=4)(
        jnp.asarray(P), jnp.asarray(counts), jnp.asarray(r0), jnp.asarray(r1), "xla"))
    got = transac.guess_motion_rows(
        torch.as_tensor(P), torch.as_tensor(counts), torch.as_tensor(r0), torch.as_tensor(r1))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), [0.0, 0.0, 1.0])
    # the batched form (K2's caller) picks the same rows
    both = transac.guess_motion_window_batched(
        torch.as_tensor(P)[None].expand(2, -1, -1, -1), torch.as_tensor(counts)[None].expand(2, -1),
        None, 64, pairs=(torch.as_tensor(r0)[None].expand(2, -1, -1),
                          torch.as_tensor(r1)[None].expand(2, -1, -1)))
    torch.testing.assert_close(both[1], got, rtol=0, atol=0)


def test_sample_pairs_distinct_and_in_range():
    g = torch.Generator().manual_seed(0)
    counts = torch.tensor([0, 1, 2, 3, 37], dtype=torch.int32)
    r0, r1 = transac.sample_pairs(g, 1000, counts)
    assert r0.shape == (5, 1000)
    assert torch.all(r0 != r1)
    hi = torch.clamp(counts.long(), min=2)[:, None]
    assert torch.all((r0 >= 0) & (r0 < hi) & (r1 >= 0) & (r1 < hi))
    assert set(r0[4].tolist()) == set(range(37))  # every row is drawn


def _motion(rng, F):
    M = rng.normal(size=(F, 3)).astype(np.float32)
    return M / np.linalg.norm(M, axis=-1, keepdims=True)


def test_cost_with_motion_matches_jax(scenes):
    jp, table, wins = scenes
    jw = jp.windows[1]
    M = _motion(np.random.default_rng(1), jw.num_frames)
    for d in (0.0, 0.0423):
        P = np.array(jcompute(jp.table, jw, jnp.float32(d)))
        want = float(jpresync.cost_with_motion(jnp.asarray(P), jnp.asarray(M), jw.frame_mask))
        got = float(tpresync.cost_with_motion(
            torch.as_tensor(P), torch.as_tensor(M), wins[1].frame_mask))
        assert got == pytest.approx(want, rel=RTOL)


def test_window_cost_is_one_point_of_presync_scan(scenes):
    """window_cost at one delay draws the same pairs as a one-point
    presync_scan from an equally seeded generator."""
    jp, table, wins = scenes
    d = torch.tensor([0.02])
    one = tpresync.window_cost(table, wins[0], d[0], torch.Generator().manual_seed(5))
    scan = tpresync.presync_scan(table, wins[0], d, torch.Generator().manual_seed(5))
    torch.testing.assert_close(one, scan[0], rtol=0, atol=0)


def test_frame_loss_matches_jax(scenes):
    jp, table, wins = scenes
    P = np.array(jcompute(jp.table, jp.windows[0], jnp.float32(0.05)))[:, 3]
    M = _motion(np.random.default_rng(6), 1)[0] * 1.7
    want = float(jsync.frame_loss(jnp.asarray(P), jnp.asarray(M), 250.0))
    got = float(tsync.frame_loss(torch.as_tensor(P), torch.as_tensor(M), 250.0))
    assert got == pytest.approx(want, rel=RTOL)


def test_window_loss_and_delay_derivative_match_jax_jvp(scenes):
    jp, table, wins = scenes
    jw = jp.windows[0]
    rng = np.random.default_rng(2)
    M = _motion(rng, jw.num_frames)
    var_k = rng.uniform(10, 1000, size=jw.num_frames).astype(np.float32)
    jvp = jax.jit(lambda d: jax.jvp(
        lambda x: jsync.window_loss(jp.table, jw, x, jnp.asarray(M), jnp.asarray(var_k)),
        (d,), (jnp.float32(1.0),)))
    # Off the true delay (0.0423): there the rows vanish to ~1e-4 and
    # float32 rounding of the rotated rays sets the gradient's 4th digit
    # in any f32 evaluation (against float64: 1.7e-4 here, 1.6e-5 JAX).
    for d in (0.03, 0.05, 0.06):
        want_f, want_g = jvp(jnp.float32(d))
        got_f, got_g = tsync._loss_and_grad(
            table, wins[0].map(lambda x: x[None]), torch.tensor([d]),
            torch.as_tensor(M)[None], torch.as_tensor(var_k)[None])
        assert float(got_f[0]) == pytest.approx(float(want_f), rel=1e-4)
        assert float(got_g[0]) == pytest.approx(float(want_g), rel=1e-4)


def test_motion_irls_matches_jax(scenes):
    jp, table, wins = scenes
    jw = jp.windows[0]
    P = np.array(jcompute(jp.table, jw, jnp.float32(0.02)))
    rng = np.random.default_rng(3)
    M = _motion(rng, jw.num_frames)
    var_k = rng.uniform(10, 1000, size=jw.num_frames).astype(np.float32)
    want = np.asarray(jax.jit(jsync.motion_irls)(
        jnp.asarray(P), jnp.asarray(M), jnp.asarray(var_k)))
    got = tsync.motion_irls(torch.as_tensor(P), torch.as_tensor(M), torch.as_tensor(var_k))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_stacked_padding_is_masked(scenes):
    """stack_windows pads frames and features; padded frames have count
    0 and padded entries drop out of the rows and the cost."""
    jp, table, wins = scenes
    short = wins[1].map(lambda x: x[..., :7, :] if x.dim() >= 2 else x[:7])
    short = tproblem.TrackWindow(**{**short.__dict__, "rays_a": wins[1].rays_a[:, :7],
                                    "rays_b": wins[1].rays_b[:, :7]})
    narrow = short.map(lambda x: x[..., :20] if x.shape[-1] == 24 else x)
    stacked = stack_windows([wins[0], narrow])
    assert stacked.counts.shape == (2, 10)
    assert stacked.counts[1, 7:].tolist() == [0, 0, 0]
    d = torch.tensor([0.02, 0.02])
    P = tproblem.compute_problem(table, stacked, d)
    assert torch.all(P[1, :, 7:] == 0) and torch.all(P[1, :, :, 20:] == 0)
    torch.testing.assert_close(
        P[1, :, :7, :20], tproblem.compute_problem(table, narrow, d[1]), rtol=0, atol=0)
    M = torch.as_tensor(_motion(np.random.default_rng(4), 10))
    cost = tpresync.cost_with_motion(P[1], M, stacked.frame_mask[1])
    assert float(cost) == pytest.approx(
        float(tpresync.cost_with_motion(P[1, :, :7, :20], M[:7], narrow.frame_mask)), rel=1e-6)


def test_batched_sync_freezes_finished_windows(scenes):
    """The masked loop: each window runs exactly as it would alone, a
    finished window stops changing, traces stay NaN past `iterations`."""
    jp, table, wins = scenes
    stacked = stack_windows(wins)
    # starts from which the two windows stop after different trip counts
    # (15 and 10), so one runs on frozen while the other finishes
    d0 = torch.tensor([0.035, 0.045])
    M0, var_k = tsync.init_motion_batched(table, stacked, d0, torch.Generator().manual_seed(0))
    centers = torch.zeros(2)
    radius = torch.full((2,), 0.2)
    both = tsync.sync_loop(table, stacked, d0, M0, var_k, centers, radius)
    assert both.iterations[0] != both.iterations[1]
    for w in range(2):
        one = tsync.sync_loop(
            table, wins[w].map(lambda x: x[None]), d0[w:w + 1], M0[w:w + 1],
            var_k[w:w + 1], centers[:1], radius[:1])
        n = int(one.iterations[0])
        assert int(both.iterations[w]) == n
        torch.testing.assert_close(both.delay[w], one.delay[0], rtol=0, atol=1e-9)
        torch.testing.assert_close(
            both.trace_delay[w, :n], one.trace_delay[0, :n], rtol=0, atol=1e-9)
        assert torch.isfinite(both.trace_delay[w, :n]).all()
        assert torch.isnan(both.trace_delay[w, n:]).all()
        assert torch.isnan(both.trace_step[w, n:]).all()
        assert abs(float(both.delay[w]) - SCENE.get("true_delay", 0.0423)) < 5e-4
