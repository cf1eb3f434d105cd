"""Multi-clip batching: windows from several clips, each with its own
gyro spline, sync as one batch.

The window axis holds the windows of every clip; this module adds the
per-window spline-table axis so the batch can mix clips. Tables are
padded to a common knot count with edge-replicated columns (the same
boundary semantics as the engine's clamped gather; windows are interior,
so the far extrapolation is never read, which `_check_interior`
enforces). A copy of rssync_tpu/parallel/multi.py on the port's engine:
`compute_problem` reads each window's own table from the stack, so
rssync_tpu's batched_presync_multi and batched_sync_multi (:101, :168)
are the port's batched_presync and batched_sync given a stacked table
(batched_presync takes a shared (D,) grid or a per-window (W, D) one
padded with inf, and per-window centers).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from rssync_tpu_torch.core.presync import presync_grid
from rssync_tpu_torch.core.problem import SplineTable, TrackWindow
from rssync_tpu_torch.parallel.batch import batched_presync, batched_sync, stack_windows


def stack_tables(tables: Sequence[SplineTable]) -> SplineTable:
    """Stack per-window spline tables on a leading axis, padding the
    knot axis to the batch maximum with edge-replicated columns."""
    n_max = max(t.n_knots for t in tables)

    def edge_pad(c: torch.Tensor) -> torch.Tensor:
        d = n_max - c.shape[-1]
        return c if d == 0 else torch.cat([c, c[:, -1:].expand(-1, d)], dim=1)

    return SplineTable(
        coeffs=torch.stack([edge_pad(t.coeffs) for t in tables]),
        sample_rate=torch.stack([t.sample_rate for t in tables]),
    )


def _check_interior(table: SplineTable, win: TrackWindow, delay_margin_s: float,
                    who: str) -> None:
    """Enforce the interior-window assumption for a table that will be
    padded: every valid feature's spline index, swung by
    +-delay_margin_s, must stay inside this clip's own knot range.
    Edge-padding a shorter table replaces its extrapolation with a
    per-knot sawtooth, so evaluation past the true last knot is refused
    rather than silently wrong."""
    m = win.feat_mask.cpu().numpy() > 0
    if not m.any():
        return
    i0 = np.concatenate([win.i0_a.cpu().numpy()[m], win.i0_b.cpu().numpy()[m]])
    margin = int(np.ceil(abs(delay_margin_s) * float(table.sample_rate))) + 1
    n = table.n_knots
    lo, hi = int(i0.min()) - margin, int(i0.max()) + margin
    if lo < 0 or hi >= n - 1:
        raise ValueError(
            f"{who}: window spline band [{lo}, {hi}] (with {delay_margin_s:+.3f}s delay "
            f"margin) leaves the clip's own knot interior [0, {n - 2}]; edge-padded tables "
            "are only valid for interior windows"
        )


def stack_problems(tables: Sequence[SplineTable], windows: Sequence[TrackWindow],
                   delay_margin_s: float = 0.0) -> tuple[SplineTable, TrackWindow]:
    """Stack (table, window) pairs, one table per window (repeat a clip's
    table for each of its windows). Windows whose tables get padded must
    stay interior to their own clip's knot range over the
    +-delay_margin_s search swing (checked, see _check_interior)."""
    if len(tables) != len(windows):
        raise ValueError("one table per window required")
    n_max = max(t.n_knots for t in tables)
    for i, (t, w) in enumerate(zip(tables, windows)):
        if t.n_knots < n_max:
            _check_interior(t, w, delay_margin_s, f"stack_problems[{i}]")
    return stack_tables(tables), stack_windows(windows)


def _per_clip(value, n: int) -> list:
    """Broadcast a scalar setting to n clips; pass sequences through."""
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(f"expected {n} per-clip values, got {len(value)}")
        return list(value)
    return [value] * n


def sync_clips(problems, syncpoint_lists: Sequence[Sequence[int]], sync_window_frames,
               initial_delay, presync_step, presync_radius, generator: torch.Generator,
               sync_passes: int = 4) -> list[list[float]]:
    """N SyncProblems (one per clip, tracks and gyro set, all on one
    device) x their syncpoint lists -> per-clip delay lists (seconds).
    All windows of all clips run as one batched PreSync and
    `sync_passes` batched Sync passes, drawing from `generator` in turn.

    sync_window_frames / initial_delay / presync_step / presync_radius
    may each be a scalar (shared) or a per-clip sequence: clips keep
    their own settings through per-window delay grids, centers and
    search radii."""
    n = len(problems)
    wsizes = _per_clip(sync_window_frames, n)
    inits = _per_clip(initial_delay, n)
    steps = _per_clip(presync_step, n)
    radii = _per_clip(presync_radius, n)

    tables, wins_open, wins_closed, owners = [], [], [], []
    for ci, (sp, pts) in enumerate(zip(problems, syncpoint_lists)):
        for pos in pts:
            tables.append(sp.spline_table)
            wins_open.append(sp.build_window(pos, pos + wsizes[ci], closed=False))
            wins_closed.append(sp.build_window(pos, pos + wsizes[ci], closed=True))
            owners.append(ci)
    if not owners:
        # every clip's schedule is empty (sync_window does not fit):
        # nothing to stack or launch
        return [[] for _ in problems]

    margin = max(abs(i0) + r for i0, r in zip(inits, radii))
    t_stack, w_open = stack_problems(tables, wins_open, margin)
    _, w_closed = stack_problems(tables, wins_closed, margin)

    grids = [presync_grid(inits[ci], radii[ci], steps[ci]) for ci in range(n)]
    delays_np = np.full((len(owners), max(len(g) for g in grids)), np.inf, np.float32)
    for wi, ci in enumerate(owners):
        delays_np[wi, : len(grids[ci])] = grids[ci]
    dev = t_stack.coeffs.device
    f32 = dict(dtype=torch.float32, device=dev)
    centers = torch.tensor([inits[ci] for ci in owners], **f32)
    radius_w = torch.tensor([radii[ci] for ci in owners], **f32)

    _, cur = batched_presync(t_stack, w_open, torch.tensor(delays_np, device=dev), generator,
                             centers=centers)
    for _ in range(sync_passes):
        cur = batched_sync(t_stack, w_closed, cur, centers, radius_w, generator).delay

    out: list[list[float]] = [[] for _ in problems]
    for delay, ci in zip(cur.double().cpu().tolist(), owners):
        out[ci].append(float(delay))
    return out
