"""Does an int16 compare buffer help the scoring kernel? Port of
experiments/r4_i16score.py (kernel E8). For +0, positive finite values
and +inf the bf16 bit pattern viewed as int16 orders as the value does,
so the bisection's `bf16(x) <= bf16(mid)` can run as an int16 compare on
a buffer half the size of K2's float one. (The TPU's compiler had no
16-bit vector compare; the card does.)

First a parity check of ops/score.py::score_quartile_i16 against
score_quartile_batched on small seeded inputs (must be equal), then the
engine's batched PreSync at its operating point (30 windows x 200
delays, one launch of 6000 x 60 rows) through both: K2, then E8 patched
in at the name core/ransac.py looks up. Both routes draw from the same
generator seed, so their best costs and delays must be identical; the
ms of each is the median of 3 CUDA-event-timed calls after a warm-up.

    python -m rssync_tpu_torch.experiments.r4_i16score
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from rssync_tpu_torch.core import ransac
from rssync_tpu_torch.core.presync import presync_grid
from rssync_tpu_torch.experiments._harness import card_line, main_on_card, timed
from rssync_tpu_torch.ops.score import score_quartile_batched, score_quartile_i16
from rssync_tpu_torch.parallel.batch import batched_presync, stack_windows
from rssync_tpu_torch.testing.engine_problem import (
    OPERATING_POINT,
    PRESYNC_RADIUS_MS,
    PRESYNC_STEP_MS,
    make_engine_problem,
)

#: the tests' engine problem and PreSync grid (ms)
SMALL_PROBLEM = dict(seed=3, duration=4.0, fps=30.0, n_features=40, sync_window=12,
                     syncpoint_distance=30, true_delay=-0.021)
SMALL_RADIUS_MS = 50.0


@contextlib.contextmanager
def i16_scoring():
    """Score PreSync's hypotheses with E8 in place of K2 inside the block."""
    orig = ransac.score_quartile_batched
    ransac.score_quartile_batched = score_quartile_i16
    try:
        yield
    finally:
        ransac.score_quartile_batched = orig


def parity_inputs(device, B=5, F=7, N=40, I=20, seed=0):
    """The original's parity inputs: row-normalized rows with zeroed
    padding, unit hypotheses, counts in [5, N]."""
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(B, 3, F, N)).astype(np.float32) * 0.1
    counts = rng.integers(5, N + 1, size=(B, F)).astype(np.int32)
    P *= (np.arange(N) < counts[..., None])[:, None]
    Pn2 = np.sum(P * P, axis=1)
    inv = np.where(Pn2 < 1e-24, 1.0, 1.0 / np.sqrt(np.maximum(Pn2, 1e-30)))
    nP = (P * inv[:, None]).astype(np.float32)
    v = rng.normal(size=(B, 3, F, I)).astype(np.float32)
    v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    return [torch.as_tensor(x, device=device) for x in (nP, v, counts)]


def run(variants=None, device="cuda", small: bool = False) -> dict:
    """Parity, then PreSync through K2 and E8. Returns {"parity_equal",
    "k2": {ms, cost, delay}, "i16": {...}, "identical"}. `variants` is
    accepted for the common command line and must be empty."""
    if variants:
        raise ValueError(f"r4_i16score has no variants, got {variants}")
    dev = torch.device(device)
    print(card_line(dev), flush=True)
    args = parity_inputs(dev)
    a, b = score_quartile_i16(*args), score_quartile_batched(*args)
    parity = bool(torch.equal(a, b))
    print(f"# parity max |d| = {float((a - b).abs().max()):.3e}", flush=True)
    if not parity:
        raise AssertionError("the i16 kernel diverges from K2")

    prob = make_engine_problem(**(SMALL_PROBLEM if small else OPERATING_POINT))
    table = prob.table(dev)
    wins = stack_windows(prob.windows(dev))
    radius_ms = SMALL_RADIUS_MS if small else PRESYNC_RADIUS_MS
    grid = presync_grid(0.0, radius_ms / 1000, PRESYNC_STEP_MS / 1000)
    delays = torch.tensor(grid, dtype=torch.float32, device=dev)

    def presync():
        gen = torch.Generator(device=dev).manual_seed(1)
        return batched_presync(table, wins, delays, gen)

    out = {"parity_equal": parity}
    for route in ("k2", "i16"):
        with i16_scoring() if route == "i16" else contextlib.nullcontext():
            (cost, delay), ms = timed(presync, dev, reps=3)
        out[route] = dict(ms=ms, cost=cost.cpu(), delay=delay.cpu())
        shown = "not timed (cpu)" if ms is None else f"{ms:9.2f} ms"
        print(f"presync {route:4s} {shown}  ({len(grid)} delays x {wins.counts.shape[0]} "
              f"windows)", flush=True)
    out["identical"] = bool(torch.equal(out["k2"]["cost"], out["i16"]["cost"])
                            and torch.equal(out["k2"]["delay"], out["i16"]["delay"]))
    print(f"# best costs and delays identical through K2 and E8: {out['identical']}",
          flush=True)
    return out


def main(argv=None) -> int:
    return main_on_card(run, sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    raise SystemExit(main())
