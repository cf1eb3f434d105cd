"""Batched sync: stack windows, run the engine over the window axis.

The reference syncs one window at a time (main loop,
ref core_testcode.cpp:303-316: per syncpoint PreSync then 4x Sync).
Here every syncpoint of a clip is one leading axis: PreSync becomes
(delay chunk x windows) batches, and Sync one masked loop in which
windows that converge first freeze while the rest continue.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F_

from rssync_tpu_torch.core.presync import (
    PRESYNC_RANSAC_ITERS,
    cost_with_motion,
    delay_chunk,
)
from rssync_tpu_torch.core.problem import SplineTable, TrackWindow, compute_problem
from rssync_tpu_torch.core.ransac import guess_motion_window_batched, sample_pairs
from rssync_tpu_torch.core.sync import SyncResult, init_motion_batched, sync_loop
from rssync_tpu_torch.utils.timing import span


def stack_windows(windows: Sequence[TrackWindow]) -> TrackWindow:
    """Stack single (unbatched) windows into one batch with a leading
    W axis, padding frames/features to the batch maxima (padded frames
    have count 0, padded features are masked)."""
    Fm = max(w.num_frames for w in windows)
    Nm = max(w.num_features for w in windows)

    def pad(win: TrackWindow) -> TrackWindow:
        df = Fm - win.num_frames
        dn = Nm - win.num_features

        def pf(x):
            # (F,) fields pad frames; (F, N) and (3, F, N) fields both
            return F_.pad(x, (0, df) if x.dim() == 1 else (0, dn, 0, df))

        return win.map(pf)

    padded = [pad(w) for w in windows]
    return TrackWindow(**{
        name: torch.stack([getattr(w, name) for w in padded])
        for name in TrackWindow.__dataclass_fields__
    })


@torch.no_grad()
def presync_costs(
    table: SplineTable, wins: TrackWindow, delays: torch.Tensor,
    generator: torch.Generator, centers: torch.Tensor | None = None, pairs=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """PreSync costs of every window at every grid entry.

    wins: stacked TrackWindow with leading W axis; table: one spline
    table, or one per window stacked on a leading W axis
    (parallel/multi.py::stack_tables). delays: a shared (D,) grid, or a
    per-window (W, D) grid padded with inf. centers: (W,) where
    non-finite grid entries are evaluated (finite, so no inf reaches
    the floor and int32 casts; they score inf); by default each
    window's finite-grid midpoint. pairs: RANSAC index pairs (r0, r1),
    each (D, W, F, PRESYNC_RANSAC_ITERS), drawn from `generator` for
    the whole grid up front when not given, so the chunk size never
    changes them. Returns (costs (Dp, W), grid (W, Dp)): the grid padded
    with inf to a whole number of chunks sized to device memory.
    """
    W, F = wins.counts.shape
    N = wins.num_features
    grid = delays if delays.dim() == 2 else delays[None].expand(W, -1)
    D = grid.shape[1]
    if centers is None:
        finite = torch.isfinite(grid)
        lo = torch.where(finite, grid, math.inf).min(dim=1).values
        hi = torch.where(finite, grid, -math.inf).max(dim=1).values
        centers = 0.5 * (lo + hi)
    K = delay_chunk(grid.device, D, W * F * N)
    pad = (-D) % K
    grid_p = F_.pad(grid, (0, pad), value=math.inf)  # (W, Dp)
    if pairs is None:
        pairs = sample_pairs(generator, PRESYNC_RANSAC_ITERS, wins.counts.expand(D, W, F))
    r0, r1 = (F_.pad(r, (0, 0, 0, 0, 0, 0, 0, pad)) for r in pairs)  # (Dp, W, F, I)
    counts = wins.counts.expand(K, W, F).reshape(K * W, F)
    costs = []
    for s in range(0, D + pad, K):
        ds = grid_p[:, s:s + K].T  # (K, W)
        ds = torch.where(torch.isfinite(ds), ds, centers)
        P = compute_problem(table, wins, ds)  # (K, W, 3, F, N)
        Pb = P.reshape(K * W, 3, F, N)
        M = guess_motion_window_batched(
            Pb, counts, generator, PRESYNC_RANSAC_ITERS,
            pairs=(r0[s:s + K].reshape(K * W, F, -1), r1[s:s + K].reshape(K * W, F, -1)),
        )  # (K * W, F, 3)
        costs.append(cost_with_motion(P, M.reshape(K, W, F, 3), wins.frame_mask))
    costs = torch.cat(costs)  # (Dp, W)
    return torch.where(torch.isfinite(grid_p.T), costs, math.inf), grid_p


def batched_presync(
    table: SplineTable, wins: TrackWindow, delays: torch.Tensor,
    generator: torch.Generator, centers: torch.Tensor | None = None, pairs=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All windows x all delay-grid points (`presync_costs`); returns
    (best_cost (W,), best_delay (W,))."""
    costs, grid_p = presync_costs(table, wins, delays, generator, centers, pairs)
    i = torch.argmin(costs, dim=0)  # (W,)
    best = grid_p.gather(1, i[:, None])[:, 0]
    return costs.gather(0, i[None])[0], best


def batched_sync(
    table: SplineTable, wins: TrackWindow, initial_delays: torch.Tensor,
    search_centers: torch.Tensor, search_radius, generator: torch.Generator,
    motion_opt: str = "irls", pairs=None,
) -> SyncResult:
    """Fine Sync over the window axis. initial_delays, search_centers:
    (W,). GuessMotion of every window is one batched scoring call.
    motion_opt: "irls" or "lbfgs" (core/sync.py::sync_loop); rssync_tpu
    computes the same as a vmap of its sync_window. pairs: GuessMotion's
    RANSAC index pairs (r0, r1), each (W, F, SYNC_RANSAC_ITERS), in
    place of the draw from `generator`. Span `sync.init`: GuessMotion."""
    radius = torch.as_tensor(
        search_radius, dtype=initial_delays.dtype, device=initial_delays.device
    ).expand(initial_delays.shape)
    with torch.no_grad(), span("sync.init"):
        M0, var_k = init_motion_batched(table, wins, initial_delays, generator, pairs)
    return sync_loop(table, wins, initial_delays, M0, var_k, search_centers, radius, motion_opt)


def batched_sync_pipeline(
    table: SplineTable, wins_open: TrackWindow, wins_closed: TrackWindow,
    delays: torch.Tensor, initial_delay, search_radius, generator: torch.Generator,
    passes: int = 4, motion_opt: str = "irls",
) -> tuple[torch.Tensor, list[SyncResult]]:
    """The whole per-clip engine: batched PreSync over the delay grid on
    the open windows, then `passes` Sync passes on the closed ones (the
    reference's 4x loop, ref core_testcode.cpp:308-314) centered on
    initial_delay, each re-initializing motion at the delay the last
    one reached, exactly like separate calls drawing from `generator`
    in turn. Returns (presync_best (W,), [SyncResult per pass])."""
    _, best = batched_presync(table, wins_open, delays, generator)
    centers = torch.full_like(best, float(initial_delay))
    cur, results = best, []
    for _ in range(passes):
        res = batched_sync(table, wins_closed, cur, centers, search_radius, generator,
                           motion_opt)
        cur = res.delay
        results.append(res)
    return best, results
