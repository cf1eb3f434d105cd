"""The benchmark's arithmetic on fixed inputs."""

import numpy as np
import pytest

from portbench.metrics import arith
from portbench.reference.truth import grid_points


def test_union_and_idle_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert arith.union_s(spans) == pytest.approx(3.0)
    assert arith.idle_gaps(spans, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert arith.union_s([]) == 0.0


def test_percentile_and_rate():
    vals = list(range(1, 101))
    assert arith.percentile(vals, 90) == pytest.approx(90.1)
    assert arith.percentile([2.0], 90) == 2.0
    assert arith.per_request(51.0, 17) == pytest.approx(3.0)
    assert arith.per_request(51.0, 0) is None


def _strip_inputs_covered(seed, T, Hp, Wp, B, N):
    """Lane blocks the seeded strips of profile_strips.strip_inputs
    cover (its numpy draws, frame b for pair b)."""
    rng = np.random.default_rng(seed)
    oyq = rng.integers(0, (Hp - 40) // 8 + 1, (B, N))
    obx = rng.integers(0, Wp // 128 - 2 + 1, (B, N))
    rows = np.arange(B)[:, None, None] * Hp + 8 * oyq[..., None] + np.arange(40)
    idx = rows[..., None] * (Wp // 128) + obx[..., None, None] + np.arange(2)
    return len(np.unique(idx))


@pytest.mark.parametrize("seed,Hp,Wp,ms", [(1, 2056, 2816, 0.0120), (0, 536, 768, 0.0082)])
def test_k3_bytes_reproduce_the_bounds_of_record(seed, Hp, Wp, ms):
    """PERF.md's K3 bounds at T = B = 16, N = 130 (chip_smoke phase 10's
    seeds): 0.0120 ms at level 0, 0.0082 ms at level 2."""
    covered = _strip_inputs_covered(seed, 16, Hp, Wp, 16, 130)
    assert round(arith.bound_s(arith.k3_bytes(covered, 16, 130), 0) * 1e3, 4) == ms


def test_k2_ops_reproduce_the_bound_of_record():
    """PERF.md's K2 bound, 0.2079 ms at B = 6000, F = 60, N = 130,
    I = 20, with the valid features of score_inputs' draw (58 of each 60
    rows hold U{65..130}, one 0 and one 1)."""
    rows = 6000 * 60
    valid = 6000 * (58 * 97.5 + 1)
    assert round(arith.score_ops_s(rows, 20, valid, 130) * 1e3, 4) == 0.2079


def test_strip_covered_blocks():
    # one point: one strip of 40 rows x 2 blocks
    assert arith.strip_covered_blocks([(600.0, 600.0)], 2028, 2704, 0, 10, 4) == 80
    # two points in one lane band and row band share every block
    assert arith.strip_covered_blocks([(600.0, 600.0), (610.0, 602.0)], 2028, 2704, 0, 10,
                                      4) == 80
    # a point at the corner is clamped inside the level
    assert arith.strip_covered_blocks([(0.0, 0.0)], 2028, 2704, 0, 10, 4) == 80
    assert arith.level_dims(2028, 2704, 2) == (536, 6)
    grid = grid_points(2704, 2028, 200)
    assert arith.strip_covered_blocks(grid, 2028, 2704, 0, 10, 4) <= 130 * 80


def test_trace_readings():
    """Busy time, kernel time inside a span and the breakdown's idle
    seconds by span, on a fixed trace."""
    from portbench.tracing import Trace

    t = Trace(device=[("gather_strips_tma_kernel", 0.1, 0.2), ("k2 score_regs_kernel<4>", 0.5, 0.6),
                      ("j", 0.55, 0.9)],
              spans=[("track", 0, 0.0, 0.4), ("presync", 0, 0.4, 1.0)], t0=0.0, t1=1.0,
              requests=[])
    assert t.busy_s == pytest.approx(0.5)
    assert t.kernel_s(("score_regs_kernel",), within="presync") == pytest.approx(0.1)
    assert t.kernel_s(("score_regs_kernel",), within="track") is None
    assert t.kernel_s(("absent",)) is None
    b = t.breakdown()
    assert b["idle_gaps"] == [["track", pytest.approx(0.4)], ["presync", pytest.approx(0.1)]]
    assert b["device_ops"][0][0] == "j"


def test_k2_roofline_fails_without_its_kernel():
    """On a device trace, the K2 reader fails when none of its kernels ran
    inside a presync span, and reads nothing without a device trace."""
    from types import SimpleNamespace

    from portbench import harness
    from portbench.tracing import Trace

    reader = harness._reader(harness.ROOT, "k2_roofline.clip")
    t = Trace(device=[("gather_strips_tma_kernel", 0.1, 0.2)],
              spans=[("presync", 0, 0.0, 1.0)], t0=0.0, t1=1.0, requests=[])
    with pytest.raises(RuntimeError, match="k2_roofline"):
        reader.read(SimpleNamespace(trace=t))
    assert reader.read(SimpleNamespace(trace=Trace([], t.spans, 0.0, 1.0, []))) is None
