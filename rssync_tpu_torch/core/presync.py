"""PreSync: brute-force coarse delay search
(ref: src/core/core_private.cpp:61-90, 336-361).

The reference runs a sequential delay loop with a parallel frame loop
inside; here a chunk of delays is one batch of tensor ops, and a Python
loop walks the chunks. The chunk size bounds the device memory that the
(delays x frames x features) intermediates take.
"""

from __future__ import annotations

import torch

from rssync_tpu_torch.core.problem import SplineTable, TrackWindow, compute_problem
from rssync_tpu_torch.core.ransac import (
    guess_motion_rows,
    guess_motion_window,
    sample_pairs,
)
from rssync_tpu_torch.ops.robust import clamp_k

#: RANSAC hypothesis count inside the coarse cost (ref :77).
PRESYNC_RANSAC_ITERS = 20

#: peak device bytes one (delay, window, frame, feature) element takes
#: across compute_problem, scoring and the cost. Measured on an H100 at
#: the engine's operating point (30 windows x 60 frames x 130 features):
#: 169.5 B with all 200 delays in one chunk (7.39 GiB peak), at most
#: 186 B with chunks of 100 delays; rounded up. With it the 200-delay
#: grid runs as one chunk on an 80 GB card.
#: `python -m rssync_tpu_torch.testing.profile_engine` re-measures it.
BYTES_PER_ELEMENT = 192

#: delay-chunk memory budget: an eighth of the card's memory, or a fixed
#: 256 MiB on the CPU. It depends on the device, never on what is free
#: at the moment, so results do not depend on other allocations.
CPU_CHUNK_BYTES = 256 << 20


def delay_chunk(device: torch.device, n_delays: int, elems_per_delay: int) -> int:
    """Delays per chunk: as many as the budget holds, spread evenly
    over the fewest chunks."""
    if device.type == "cuda":
        budget = torch.cuda.get_device_properties(device).total_memory // 8
    else:
        budget = CPU_CHUNK_BYTES
    most = max(1, budget // max(1, elems_per_delay * BYTES_PER_ELEMENT))
    n_chunks = -(-max(n_delays, 1) // most)
    return -(-max(n_delays, 1) // n_chunks)


def presync_grid(initial_delay: float, radius: float, step: float) -> list:
    """The reference's f64-accumulated PreSync delay grid
    (ref core_private.cpp:69-70: `for (d = rough - radius;
    d < rough + radius; d += step)`). The sequential f64 accumulation
    decides whether the final grid point lands inside the half-open
    bound, so every call site shares this function."""
    grid = []
    d = float(initial_delay) - float(radius)
    hi = float(initial_delay) + float(radius)
    step = float(step)
    while d < hi:
        grid.append(d)
        d += step
    return grid


def cost_with_motion(
    P: torch.Tensor, M: torch.Tensor, frame_mask: torch.Tensor
) -> torch.Tensor:
    """Window cost given per-frame translation directions.

    P (..., 3, F, N), M (..., F, 3), frame_mask (..., F) -> (...). Per
    frame (ref core_private.cpp:79-85):
        k = clamp(1e2 / |P M|, 10, 1000)
        r = (P M) * k / |M|
        frame cost = sqrt( sum_i sqrt(log1p(r_i^2)) )
    window cost = sum over valid frames.
    """
    P0, P1, P2 = P.unbind(-3)
    M0, M1, M2 = (m[..., None] for m in M.unbind(-1))
    PM = P0 * M0 + P1 * M1 + P2 * M2  # (..., F, N)
    k = clamp_k(1e2 / torch.clamp(torch.sqrt(torch.sum(PM * PM, dim=-1)), min=1e-30))
    Mn = torch.clamp(torch.sqrt(torch.sum(M * M, dim=-1)), min=1e-30)
    r = PM * (k / Mn)[..., None]
    rho = torch.log1p(r * r)
    frame_cost = torch.sqrt(torch.sum(torch.sqrt(rho), dim=-1))
    return torch.sum(frame_cost * frame_mask, dim=-1)


def window_cost(
    table: SplineTable, win: TrackWindow, delay, generator: torch.Generator
) -> torch.Tensor:
    """Approximate sync cost of one window at one delay
    (ref core_private.cpp:73-86): per-frame 20-hypothesis RANSAC
    motion, then the robust cost above."""
    P = compute_problem(table, win, delay)  # (3, F, N)
    M = guess_motion_window(P, win.counts, generator, PRESYNC_RANSAC_ITERS)
    return cost_with_motion(P, M, win.frame_mask)


def presync_scan(
    table: SplineTable, win: TrackWindow, delays: torch.Tensor,
    generator: torch.Generator,
) -> torch.Tensor:
    """Costs of one window at every delay in `delays` (D,): the
    reference's sequential loop (ref :69-87) as chunks of delays. Fresh
    RANSAC draws per (delay, frame), drawn for the whole grid up front
    so the chunking never changes them. Each chunk's (delay x frame)
    rows go to the scoring kernel as one flattened row axis."""
    D = delays.shape[0]
    F, N = win.num_frames, win.num_features
    r0, r1 = sample_pairs(
        generator, PRESYNC_RANSAC_ITERS, win.counts.expand(D, F)
    )  # (D, F, I)
    K = delay_chunk(delays.device, D, F * N)
    out = []
    for s in range(0, D, K):
        ds = delays[s:s + K]
        k = ds.shape[0]
        P = compute_problem(table, win, ds)  # (k, 3, F, N)
        rows = P.transpose(0, 1).reshape(3, k * F, N)
        M = guess_motion_rows(
            rows, win.counts.repeat(k),
            r0[s:s + k].reshape(k * F, -1), r1[s:s + k].reshape(k * F, -1),
        ).reshape(k, F, 3)
        out.append(cost_with_motion(P, M, win.frame_mask))
    return torch.cat(out)


def presync_best(costs: torch.Tensor, delays: torch.Tensor):
    """(min cost, argmin delay) — the pair-compare of ref :89."""
    i = torch.argmin(costs)
    return costs[i], delays[i]
