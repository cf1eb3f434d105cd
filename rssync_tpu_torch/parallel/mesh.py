"""Sharding a window batch over devices.

Sync windows are independent, so the batch's leading window axis splits
into contiguous blocks, one a shard, as rssync_tpu's 1-D mesh lays it
out (`P(WINDOW_AXIS)`). One process drives every device: a worker thread
a distinct device runs its shards' batched PreSync / Sync in order, and
the (W,) results are gathered onto the mesh's first device in window
order. There is no collective on the hot path, so neither
`torch.distributed` nor DTensor is used (the kernels are ctypes
launches that DTensor cannot partition).

A mesh may name one device several times: several shards on one device
is how the CPU tests and a one-card machine run the same code. Every
RANSAC pair of the batch is drawn up front from the one generator by
the same `sample_pairs` call the unsharded run makes and sliced per
shard, so the split changes no draw; only the order of a reduction may
differ from the unsharded run.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F_

from rssync_tpu_torch.core.presync import PRESYNC_RANSAC_ITERS
from rssync_tpu_torch.core.problem import SplineTable, TrackWindow
from rssync_tpu_torch.core.ransac import sample_pairs
from rssync_tpu_torch.core.sync import SYNC_RANSAC_ITERS, SyncResult
from rssync_tpu_torch.parallel.batch import batched_presync, batched_sync

WINDOW_AXIS = "windows"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the window axis: shard i lives on devices[i]."""

    devices: tuple[torch.device, ...]
    axis_name = WINDOW_AXIS  # the one axis; not a field

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None) -> Mesh:
    """A mesh over `devices` as given (repeats allowed), or over every
    CUDA card when None; raises where there is none."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= to shard elsewhere")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: empty device list")
    return Mesh(devices)


def pad_to_multiple(wins: TrackWindow, multiple: int) -> tuple[TrackWindow, int]:
    """Pad the leading window axis to a multiple of the mesh size with
    all-zero windows (frame_mask 0: zero cost, converged at once).
    Returns (padded windows, the original window count)."""
    W = wins.frame_mask.shape[0]
    pad = (-W) % multiple
    if pad == 0:
        return wins, W
    return wins.map(lambda x: F_.pad(x, (0, 0) * (x.dim() - 1) + (0, pad))), W


def _block(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Contiguous blocks of x's leading axis, block i on mesh.devices[i]."""
    W, n = x.shape[0], mesh.size
    if W % n:
        raise ValueError(f"{W} windows do not split over {n} shards; use pad_to_multiple")
    m = W // n
    return [x[i * m:(i + 1) * m].to(d) for i, d in enumerate(mesh.devices)]


def shard_windows(wins: TrackWindow, mesh: Mesh) -> list[TrackWindow]:
    """The stacked window batch split into mesh.size contiguous blocks,
    block i on mesh.devices[i]. Requires W % mesh.size == 0."""
    fields = {name: _block(getattr(wins, name), mesh)
              for name in TrackWindow.__dataclass_fields__}
    return [TrackWindow(**{k: v[i] for k, v in fields.items()}) for i in range(mesh.size)]


def replicate_table(table: SplineTable, mesh: Mesh) -> list[SplineTable]:
    """One spline table copied to every shard's device; a stacked table
    (one per window, parallel/multi.py) is split like the windows."""
    if table.coeffs.dim() == 3:
        c, r = _block(table.coeffs, mesh), _block(table.sample_rate, mesh)
        return [SplineTable(coeffs=ci, sample_rate=ri) for ci, ri in zip(c, r)]
    return [SplineTable(coeffs=table.coeffs.to(d), sample_rate=table.sample_rate.to(d))
            for d in mesh.devices]


def shard_vector(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """A (W, ...) per-window tensor split like the windows."""
    return _block(x, mesh)


def _shards(x, mesh: Mesh, place) -> list:
    """x as shards: a list is taken as already placed, else `place`d."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.size:
            raise ValueError(f"{len(x)} shards for a mesh of {mesh.size}")
        return list(x)
    return place(x, mesh)


def _run(mesh: Mesh, fn, *per_shard: Sequence) -> list:
    """fn(*args of shard i) for every shard: one thread a distinct
    device, that device's shards in order. Returns results in shard
    order."""
    order: dict[torch.device, list[int]] = {}
    for i, d in enumerate(mesh.devices):
        order.setdefault(d, []).append(i)
    out = [None] * mesh.size

    def worker(dev: torch.device, idx: list[int]) -> None:
        ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with ctx:
            for i in idx:
                out[i] = fn(*(a[i] for a in per_shard))

    with ThreadPoolExecutor(max_workers=len(order)) as pool:
        for f in [pool.submit(worker, d, idx) for d, idx in order.items()]:
            f.result()
    return out


def _gather(parts: list[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Per-shard results concatenated on mesh.devices[0] in window order."""
    return torch.cat([p.to(mesh.devices[0]) for p in parts])


def _counts(wins: list[TrackWindow], generator: torch.Generator) -> torch.Tensor:
    """The whole batch's (W, F) counts on the generator's device."""
    return torch.cat([w.counts.to(generator.device) for w in wins])


def _split_pairs(pairs, wins: list[TrackWindow], axis: int) -> list[tuple]:
    """Slice batch-wide pairs (r0, r1) along the window `axis` into the
    shards' blocks, each on its shard's device."""
    out, s = [], 0
    for w in wins:
        n = w.counts.shape[0]
        dev = w.counts.device
        out.append(tuple(r.narrow(axis, s, n).to(dev) for r in pairs))
        s += n
    return out


def sharded_presync(
    table, wins, delays: torch.Tensor, generator: torch.Generator, mesh: Mesh,
    centers: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """parallel/batch.py::batched_presync with the window axis sharded.

    table: one spline table, a stacked one (one per window), or their
    shards (replicate_table); wins: the stacked windows or their shards
    (shard_windows); delays: a shared (D,) grid or a per-window (W, D)
    one; centers: optional (W,). The pairs of the whole (D, W) batch
    are drawn from `generator` first. Returns (best_cost (W,),
    best_delay (W,)) on mesh.devices[0]."""
    wins = _shards(wins, mesh, shard_windows)
    tables = _shards(table, mesh, replicate_table)
    counts = _counts(wins, generator)
    D = delays.shape[-1]
    pairs = sample_pairs(generator, PRESYNC_RANSAC_ITERS, counts.expand(D, *counts.shape))
    grids = ([delays.to(w.counts.device) for w in wins] if delays.dim() == 1
             else shard_vector(delays, mesh))
    cents = [None] * mesh.size if centers is None else shard_vector(centers, mesh)

    def one(t, w, g, c, p):
        return batched_presync(t, w, g, generator, centers=c, pairs=p)

    res = _run(mesh, one, tables, wins, grids, cents, _split_pairs(pairs, wins, 1))
    return _gather([r[0] for r in res], mesh), _gather([r[1] for r in res], mesh)


def sharded_sync(
    table, wins, initial_delays, search_centers, search_radius,
    generator: torch.Generator, mesh: Mesh, motion_opt: str = "irls",
) -> SyncResult:
    """parallel/batch.py::batched_sync with the window axis sharded.

    table, wins as for sharded_presync; initial_delays, search_centers:
    (W,) tensors or their shards (shard_vector); search_radius: a scalar
    or (W,). GuessMotion's pairs for the whole batch are drawn from
    `generator` first. Returns the SyncResult of every window, each
    field gathered on mesh.devices[0]."""
    wins = _shards(wins, mesh, shard_windows)
    tables = _shards(table, mesh, replicate_table)
    d0 = _shards(initial_delays, mesh, shard_vector)
    cen = _shards(search_centers, mesh, shard_vector)
    if isinstance(search_radius, torch.Tensor) and search_radius.dim() > 0:
        radii = _shards(search_radius, mesh, shard_vector)
    else:
        radii = [search_radius] * mesh.size
    pairs = sample_pairs(generator, SYNC_RANSAC_ITERS, _counts(wins, generator))

    def one(t, w, d, c, r, p):
        return batched_sync(t, w, d, c, r, generator, motion_opt, pairs=p)

    res = _run(mesh, one, tables, wins, d0, cen, radii, _split_pairs(pairs, wins, 0))
    return SyncResult(*(_gather(list(f), mesh) for f in zip(*res)))
