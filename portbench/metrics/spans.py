"""Readings of the harness spans of a traced run's measured window (each
span ends on a device synchronize there, so it holds its device work)."""

from __future__ import annotations


def per_request_s(ctx, name: str) -> list[float]:
    """Seconds inside spans `name`, summed per completed request of the
    window."""
    reqs = {r.index for r in ctx.window_requests()}
    out: dict[int, float] = {}
    for sp in ctx.spans:
        if sp.name == name and sp.request in reqs:
            out[sp.request] = out.get(sp.request, 0.0) + sp.end - sp.start
    return list(out.values())


def windows_synced(ctx) -> int:
    return sum(len(r.windows) for r in ctx.window_requests())


def pairs_tracked(ctx) -> int:
    """Frame pairs the completed requests of the window tracked."""
    return windows_synced(ctx) * (int(ctx.cell.config["recipe"]["sync_window"]) + 1)


def ms_per_pair(ctx, name: str) -> float | None:
    secs, pairs = per_request_s(ctx, name), pairs_tracked(ctx)
    return 1e3 * sum(secs) / pairs if secs and pairs else None


def ms_per_request(ctx, name: str) -> float | None:
    secs = per_request_s(ctx, name)
    return 1e3 * sum(secs) / len(secs) if secs else None


def idle_pct(ctx) -> float | None:
    """100 x (1 - device busy / traced window) of the profiled requests."""
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
