"""K2, PreSync's RANSAC scoring: the share of its operations bound.

The operations are what the profiled requests' PreSync needs, counted
from their shapes: delays x windows x frames rows of every valid
feature against 20 hypotheses each; the time is the device time of
KERNELS inside the `presync` spans. A traced run in which none of them
ran there fails: the work is the request's, so a PreSync that another
kernel does needs its name listed here, and the share never reads 0."""

from portbench.metrics import arith
from portbench.reference.truth import grid_points

KERNELS = ("score_regs_kernel", "score_wide_kernel")
#: RANSAC hypotheses a PreSync row scores (ref core_private.cpp:77)
HYPOTHESES = 20


def _grid_len(radius: float, step: float) -> int:
    """Points of the reference's f64-accumulated grid over
    [-radius, radius)."""
    n, d = 0, -radius
    while d < radius:
        n += 1
        d += step
    return n


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:  # no device trace (a run on the CPU)
        return None
    t = tr.kernel_s(KERNELS, within="presync")
    if not t:
        raise RuntimeError(f"k2_roofline: none of {KERNELS} ran inside a presync span")
    cfg = ctx.cell.config
    rec = cfg["recipe"]
    D = _grid_len(rec["presync_radius_ms"] / 1e3, rec["presync_step_ms"] / 1e3)
    F = int(rec["sync_window"])
    N = len(grid_points(int(cfg["camera"]["width"]), int(cfg["camera"]["height"]),
                        int(cfg["tracker"]["grid_step"])))
    rows = sum(D * len(r.windows) * F for r in tr.requests)
    return 100.0 * arith.score_ops_s(rows, HYPOTHESES, rows * N, N) / t
