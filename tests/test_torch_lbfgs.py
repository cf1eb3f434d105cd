"""Parity of the port's batched L-BFGS motion refinement and its
`motion_opt="lbfgs"` Sync with rssync_tpu's on identical inputs: the
frame-loss problem of an engine window at a fixed P and var_k, from the
same starting directions."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rssync_tpu.core import problem as jproblem
from rssync_tpu.core import sync as jsync
from rssync_tpu.testing.engine_problem import make_engine_problem as jmake
from rssync_tpu_torch.core import problem as tproblem
from rssync_tpu_torch.core import sync as tsync
from rssync_tpu_torch.parallel.batch import stack_windows
from rssync_tpu_torch.utils.timing import recording

torch.set_num_threads(2)

CPU = torch.device("cpu")
#: test_torch_problem.py's scene: 2 windows of 10 frames x 24 features
SCENE = dict(seed=4, duration=2.0, fps=30.0, n_features=24, sync_window=10,
             syncpoint_distance=49, pad=0.05)
TRUE_DELAY = 0.0423
#: the issue-level agreement of iterates and final delays
ITERATE_TOL, DELAY_TOL_S = 1e-5, 1e-5


@pytest.fixture(scope="module")
def scene():
    jp = jmake(**SCENE)
    table = tproblem.table_from_numpy(
        np.asarray(jp.table.coeffs), np.asarray(jp.table.sample_rate), device=CPU)
    wins = [tproblem.window_from_numpy(
        *(np.asarray(getattr(w, f)) for f in (
            "rays_a", "rays_b", "i0_a", "i0_b", "f0_a", "f0_b",
            "feat_mask", "frame_mask", "counts")),
        device=CPU) for w in jp.windows]
    return jp, table, wins


def _frame_problem(jp, wi=0, delay=0.03, seed=3):
    """P (3, F, N) of one window at `delay`, unit M0 (F, 3), var_k and
    the frame mask, as numpy float32."""
    jw = jp.windows[wi]
    P = np.array(jax.jit(jproblem.compute_problem)(jp.table, jw, jnp.float32(delay)))
    rng = np.random.default_rng(seed)
    M0 = rng.normal(size=(jw.num_frames, 3)).astype(np.float32)
    M0 /= np.linalg.norm(M0, axis=-1, keepdims=True)
    var_k = rng.uniform(10, 1000, size=jw.num_frames).astype(np.float32)
    return P, M0, var_k, np.array(jw.frame_mask, np.float32)


def _jax_lbfgs(P, M0, var_k, fm):
    """rssync_tpu's batched_lbfgs on the frame losses, as its sync_window
    builds them (vmap of value_and_grad of frame_loss * mask)."""
    def vg(Ms):
        def per_frame(p, m, k, f):
            return jsync.frame_loss(p, m, k) * f
        return jax.vmap(jax.value_and_grad(per_frame, argnums=1), in_axes=(1, 0, 0, 0))(
            jnp.asarray(P), Ms, jnp.asarray(var_k), jnp.asarray(fm))

    return np.array(jax.jit(lambda m: jsync.batched_lbfgs(vg, m))(jnp.asarray(M0)))


def _port_lbfgs(P, M0, var_k, fm, **kw):
    P, var_k, fm = (torch.as_tensor(x) for x in (P, var_k, fm))
    return tsync.batched_lbfgs(
        lambda x: tsync.frame_losses_and_grads(P, x, var_k, fm), torch.as_tensor(M0), **kw)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_frame_gradient_matches_jax_autodiff(scene):
    jp, _, _ = scene
    P, M0, var_k, fm = _frame_problem(jp)
    fm[4] = 0.0  # a masked frame has loss 0 and gradient 0
    M = M0 * np.linspace(0.5, 3.0, len(M0), dtype=np.float32)[:, None]
    jf, jg = jax.vmap(jax.value_and_grad(
        lambda p, m, k, f: jsync.frame_loss(p, m, k) * f, argnums=1), in_axes=(1, 0, 0, 0))(
        jnp.asarray(P), jnp.asarray(M), jnp.asarray(var_k), jnp.asarray(fm))
    f, g = tsync.frame_losses_and_grads(*(torch.as_tensor(x) for x in (P, M, var_k, fm)))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-4)
    assert not f[4] and not torch.any(g[4])


def test_batched_lbfgs_matches_jax_float64(scene):
    """The algorithm itself (two-loop recursion, strong-Wolfe trials,
    history gating, freezing) against rssync_tpu's, in float64 where
    neither framework's rounding moves the iterates."""
    jp, _, _ = scene
    P, M0, var_k, fm = (x.astype(np.float64) for x in _frame_problem(jp))
    with jax.enable_x64(True):
        want = _jax_lbfgs(P, M0, var_k, fm)
    assert want.dtype == np.float64
    got = _port_lbfgs(P, M0, var_k, fm)
    np.testing.assert_allclose(got.x.numpy(), want, rtol=0, atol=ITERATE_TOL)
    assert int(got.iterations.max()) > 5


@pytest.mark.parametrize("wi,delay", [(0, 0.03), (1, TRUE_DELAY)])
def test_batched_lbfgs_matches_jax_float32(scene, wi, delay):
    """In float32 the same. The loss is scale-invariant in M, so |M| is
    free (it grows to ~240 on window 0 at 0.03) and one-ulp gradient
    differences move the stopping point along that free direction; what
    the loss sees, the unit direction, and the losses agree."""
    jp, _, _ = scene
    P, M0, var_k, fm = _frame_problem(jp, wi, delay)
    want = _jax_lbfgs(P, M0, var_k, fm)
    got = _port_lbfgs(P, M0, var_k, fm).x.numpy()
    np.testing.assert_allclose(_unit(got), _unit(want), rtol=0, atol=1e-4)
    f_got, _ = tsync.frame_losses_and_grads(*(torch.as_tensor(x) for x in (P, got, var_k, fm)))
    f_want, _ = tsync.frame_losses_and_grads(*(torch.as_tensor(x) for x in (P, want, var_k, fm)))
    np.testing.assert_allclose(f_got.numpy(), f_want.numpy(), rtol=1e-5, atol=1e-6)


def test_lbfgs_iterates_do_not_depend_on_check_every(scene):
    """Testing `all done` on the host only every k trips gives the same
    iterates and iteration counts bit for bit."""
    jp, _, _ = scene
    P, M0, var_k, fm = _frame_problem(jp)
    runs = [_port_lbfgs(P, M0, var_k, fm, check_every=k) for k in (1, 3, 7)]
    for r in runs[1:]:
        torch.testing.assert_close(r.x, runs[0].x, rtol=0, atol=0)
        torch.testing.assert_close(r.iterations, runs[0].iterations, rtol=0, atol=0)
    assert len(set(runs[0].iterations.tolist())) > 1  # lanes finish apart


def test_lbfgs_counters_count_trips_and_evaluations(scene):
    """The recorder's `lbfgs.trips` / `lbfgs.evaluations` counts: one
    trip per loop body (the most any lane ran), one evaluation at the
    start and one per line-search trial; nothing counted outside a
    recording."""
    jp, _, _ = scene
    P, M0, var_k, fm = _frame_problem(jp)
    calls = []

    def vg(x):
        calls.append(1)
        return tsync.frame_losses_and_grads(*(torch.as_tensor(a) for a in (P, x, var_k, fm)))

    def counts(rec):
        return {k: rec.counted(f"lbfgs.{k}") for k in ("trips", "evaluations")}

    with recording() as rec:
        res = tsync.batched_lbfgs(vg, torch.as_tensor(M0))
    assert counts(rec) == {"trips": int(res.iterations.max()), "evaluations": len(calls)}
    assert len(calls) > counts(rec)["trips"] + 1
    tsync.batched_lbfgs(vg, torch.as_tensor(M0))
    assert counts(rec)["evaluations"] == len(calls) // 2
    with recording() as fresh:
        pass
    assert counts(fresh) == {"trips": 0, "evaluations": 0}


def test_lbfgs_frozen_and_masked_lanes_keep_their_start(scene):
    jp, _, _ = scene
    P, M0, var_k, fm = _frame_problem(jp)
    fm[2] = 0.0
    frozen = torch.zeros(len(M0), dtype=torch.bool)
    frozen[5] = True
    res = _port_lbfgs(P, M0, var_k, fm, frozen=frozen)
    assert torch.isfinite(res.x).all()
    for lane in (2, 5):
        torch.testing.assert_close(res.x[lane], torch.as_tensor(M0[lane]), rtol=0, atol=0)
        assert int(res.iterations[lane]) == 0
    # the other lanes run as without the frozen one
    free = _port_lbfgs(P, M0, var_k, fm)
    keep = torch.arange(len(M0)) != 5
    torch.testing.assert_close(res.x[keep], free.x[keep], rtol=0, atol=0)


@pytest.mark.parametrize("wi,d0", [(0, 0.035), (1, 0.05)])
def test_sync_window_lbfgs_matches_jax(scene, wi, d0):
    """rssync_tpu's sync_window(motion_opt="lbfgs") against the port's
    loop from the same GuessMotion start (JAX's init_motion with the same
    key: the RANSAC draws cannot be shared across frameworks)."""
    jp, table, wins = scene
    jw = jp.windows[wi]
    key = jax.random.PRNGKey(7)
    want = jsync.sync_window(jp.table, jw, jnp.float32(d0), jnp.float32(0.0),
                             jnp.float32(0.2), key, motion_opt="lbfgs")
    M0, var_k = jax.jit(jsync.init_motion)(jp.table, jw, jnp.float32(d0), key)
    got = tsync.sync_loop(
        table, wins[wi].map(lambda x: x[None]), torch.tensor([d0]),
        torch.as_tensor(np.array(M0))[None], torch.as_tensor(np.array(var_k))[None],
        torch.zeros(1), torch.full((1,), 0.2), motion_opt="lbfgs")
    assert abs(float(got.delay[0]) - float(want.delay)) < DELAY_TOL_S
    assert abs(int(got.iterations[0]) - int(want.iterations)) <= 1
    assert abs(float(got.delay[0]) - TRUE_DELAY) < 5e-4
    assert int(got.motion_iterations[0]) > int(got.iterations[0])


def test_batched_lbfgs_sync_freezes_finished_windows(scene):
    """Two windows in one L-BFGS Sync loop run each as alone: a finished
    window's frames are frozen lanes."""
    jp, table, wins = scene
    stacked = stack_windows(wins)
    d0 = torch.tensor([0.035, 0.05])
    M0, var_k = tsync.init_motion_batched(table, stacked, d0, torch.Generator().manual_seed(0))
    centers, radius = torch.zeros(2), torch.full((2,), 0.2)
    both = tsync.sync_loop(table, stacked, d0, M0, var_k, centers, radius, "lbfgs")
    for w in range(2):
        one = tsync.sync_loop(table, wins[w].map(lambda x: x[None]), d0[w:w + 1], M0[w:w + 1],
                              var_k[w:w + 1], centers[:1], radius[:1], "lbfgs")
        n = int(one.iterations[0])
        assert int(both.iterations[w]) == n
        assert int(both.motion_iterations[w]) == int(one.motion_iterations[0])
        torch.testing.assert_close(both.delay[w], one.delay[0], rtol=0, atol=1e-9)
        torch.testing.assert_close(both.trace_delay[w, :n], one.trace_delay[0, :n],
                                   rtol=0, atol=1e-9)


def test_unknown_motion_opt_is_refused(scene):
    _, table, wins = scene
    with pytest.raises(ValueError, match="motion_opt"):
        tsync.sync_window(table, wins[0], 0.04, 0.0, 0.2, torch.Generator().manual_seed(0),
                          motion_opt="newton")
