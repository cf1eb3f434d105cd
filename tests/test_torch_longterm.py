"""The long-log drifting-delay scenario (tests/test_longterm.py, the
thesis's `longtermdrift`) through the port on the CPU: a gyro log whose
clock offset drifts 1e-4 s/s, synced window by window by the port's
batched PreSync (+-60 ms around 21 ms in 2 ms steps) and 4 batched Sync
passes at radius 60 ms, searched around each window's PreSync best.

The port has no `wide=`: its single coefficient gather reads any knot,
so the +-60 ms swing needs no band. The tier-1 case is cut to a 60 s
log with a syncpoint every 5 s (12 windows, a 5.5 ms swing); the 400 s
log of test_longterm.py, with timestamps past float32's resolution,
runs as the `slow` twin and in chip_smoke.py phase 19.

Limits are test_longterm.py's: every window within 0.5 ms of the
drifting truth, a mean error under 0.2 ms, sync_rmse under 0.2 ms,
the fitted slope within 10 % of the drift; and each window within
0.1 ms of rssync_tpu's delays on the same problem.
"""

import numpy as np
import pytest
import torch

from rssync_tpu_torch.analysis.metrics import sync_rmse
from rssync_tpu_torch.parallel.batch import batched_presync, batched_sync, stack_windows
from rssync_tpu_torch.testing.engine_problem import make_engine_problem

torch.set_num_threads(2)

DRIFT = 1.0e-4  # s/s
SCENARIO = dict(seed=4, fps=30.0, n_features=40, sync_window=30, true_delay=0.021,
                delay_drift=DRIFT)
SHORT = dict(duration=60.0, syncpoint_distance=150)
FULL = dict(duration=400.0, syncpoint_distance=600)
MAX_ERR_MS, MEAN_ERR_MS, RMSE_MS, SLOPE_REL, JAX_TOL_MS = 0.5, 0.2, 0.2, 0.1, 0.1


def _grid():
    return np.arange(-0.06, 0.06, 0.002) + 0.021


def _port_delays(prob) -> np.ndarray:
    wins = stack_windows(prob.windows("cpu"))
    table = prob.table("cpu")
    gen = torch.Generator().manual_seed(0)
    _, best = batched_presync(table, wins, torch.tensor(_grid(), dtype=torch.float32), gen)
    cur = best
    for _ in range(4):
        cur = batched_sync(table, wins, cur, best, 0.06, gen).delay
    return cur.double().numpy()


def _check(prob, got):
    t_centers = (np.asarray(prob.syncpoints) + prob.sync_window / 2) / prob.fps
    truth = prob.delay_at(t_centers)
    err_ms = np.abs(got - truth) * 1e3
    assert err_ms.max() < MAX_ERR_MS, err_ms
    assert err_ms.mean() < MEAN_ERR_MS, err_ms
    q = sync_rmse(np.asarray(prob.syncpoints, np.float64), got * 1e3)
    assert q.rmse < RMSE_MS, q.rmse
    slope = np.polyfit(t_centers, got, 1)[0]
    assert abs(slope - DRIFT) < SLOPE_REL * DRIFT, slope
    return truth


def test_drift_tracked_and_matches_jax():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from rssync_tpu.parallel import batch as JB
    from rssync_tpu.testing.engine_problem import make_engine_problem as jax_problem

    prob = make_engine_problem(**SCENARIO, **SHORT)
    W = len(prob.syncpoints)
    got = _port_delays(prob)
    truth = _check(prob, got)
    assert W >= 10 and (truth.max() - truth.min()) * 1e3 >= 5.0

    jprob = jax_problem(**SCENARIO, **SHORT)
    assert jprob.syncpoints == prob.syncpoints
    jwins = JB.stack_windows(jprob.windows)
    _, jbest = JB.batched_presync(jprob.table, jwins, jnp.asarray(_grid(), jnp.float32),
                                  jax.random.PRNGKey(0), wide=True)
    jcur = jbest
    for i in range(4):
        jcur = JB.batched_sync(jprob.table, jwins, jcur, jbest, 0.06,
                               jax.random.PRNGKey(1 + i), wide=True).delay
    np.testing.assert_allclose(got, np.asarray(jcur, np.float64), rtol=0,
                               atol=JAX_TOL_MS * 1e-3)


@pytest.mark.slow
def test_drift_tracked_full_400s_log():
    prob = make_engine_problem(**SCENARIO, **FULL)
    assert len(prob.syncpoints) >= 15
    got = _port_delays(prob)
    _check(prob, got)
    assert np.std(got * 1e3) > 2.0  # the drift is present in the data
