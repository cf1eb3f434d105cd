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
def batched_presync(
    table: SplineTable, wins: TrackWindow, delays: torch.Tensor,
    generator: torch.Generator,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All windows x all delay-grid points.

    wins: stacked TrackWindow with leading W axis. delays: (D,).
    Returns (best_cost (W,), best_delay (W,)).

    The grid runs in equal chunks sized to device memory; it is padded
    with inf to a whole number of chunks. Non-finite grid entries are
    evaluated at the grid centre (finite, so no inf reaches the floor
    and int32 casts) and score inf. RANSAC pairs for the whole grid are
    drawn up front, so the chunk size never changes them.
    """
    W, F = wins.counts.shape
    N = wins.num_features
    D = delays.shape[0]
    center = 0.5 * (torch.min(delays) + torch.max(delays))
    K = delay_chunk(delays.device, D, W * F * N)
    pad = (-D) % K
    delays_p = F_.pad(delays, (0, pad), value=math.inf)
    r0, r1 = sample_pairs(
        generator, PRESYNC_RANSAC_ITERS, wins.counts.expand(D, W, F)
    )  # (D, W, F, I)
    r0 = F_.pad(r0, (0, 0, 0, 0, 0, 0, 0, pad))
    r1 = F_.pad(r1, (0, 0, 0, 0, 0, 0, 0, pad))
    counts = wins.counts.expand(K, W, F).reshape(K * W, F)
    costs = []
    for s in range(0, D + pad, K):
        ds = delays_p[s:s + K]
        ds = torch.where(torch.isfinite(ds), ds, center)
        P = compute_problem(table, wins, ds[:, None])  # (K, W, 3, F, N)
        Pb = P.reshape(K * W, 3, F, N)
        M = guess_motion_window_batched(
            Pb, counts, generator, PRESYNC_RANSAC_ITERS,
            pairs=(r0[s:s + K].reshape(K * W, F, -1), r1[s:s + K].reshape(K * W, F, -1)),
        )  # (K * W, F, 3)
        costs.append(cost_with_motion(P, M.reshape(K, W, F, 3), wins.frame_mask))
    costs = torch.cat(costs)  # (Dp, W)
    costs = torch.where(torch.isfinite(delays_p)[:, None], costs, math.inf)
    i = torch.argmin(costs, dim=0)  # (W,)
    return costs.gather(0, i[None])[0], delays_p[i]


def batched_sync(
    table: SplineTable, wins: TrackWindow, initial_delays: torch.Tensor,
    search_centers: torch.Tensor, search_radius, generator: torch.Generator,
    motion_opt: str = "irls",
) -> SyncResult:
    """Fine Sync over the window axis. initial_delays, search_centers:
    (W,). GuessMotion of every window is one batched scoring call.
    motion_opt: "irls" or "lbfgs" (core/sync.py::sync_loop); rssync_tpu
    computes the same as a vmap of its sync_window."""
    radius = torch.as_tensor(
        search_radius, dtype=initial_delays.dtype, device=initial_delays.device
    ).expand(initial_delays.shape)
    with torch.no_grad():
        M0, var_k = init_motion_batched(table, wins, initial_delays, generator)
    return sync_loop(table, wins, initial_delays, M0, var_k, search_centers, radius, motion_opt)
