"""Track-stage caching: persist per-frame correspondences to disk so
sync experiments re-run without re-decoding and re-tracking video.

The reference has no checkpoint/resume (terminal CSVs only). Tracking
is the only expensive host-coupled stage, and its output (rays and
timestamps per frame, ~10 KB a frame) is small. Format: one .npz per
(video, frame range, tracker config) key, ragged frame data as
flattened arrays plus counts. A copy of rssync_tpu/utils/track_cache.py
on the port's SyncProblem, with the file name in one place
(`cache_path`).
"""

from __future__ import annotations

import hashlib
import os

import numpy as np


def cache_key(
    video_path: str,
    frame_begin: int,
    frame_end: int,
    grid_step,
    method: str,
    lens_params: tuple,
    ranges=None,
) -> str:
    st = os.stat(video_path)
    raw = repr((
        os.path.abspath(video_path), st.st_size, int(st.st_mtime),
        frame_begin, frame_end, grid_step, method, lens_params,
        None if ranges is None else tuple(map(tuple, ranges)),
    ))
    return hashlib.sha256(raw.encode()).hexdigest()[:24]


def cache_path(cache_dir: str, key: str) -> str:
    """The cache file of `key` in `cache_dir`: the one place that names it."""
    return os.path.join(cache_dir, f"tracks_{key}.npz")


def save_tracks(problem, path: str) -> None:
    """Serialize a SyncProblem's frame data (ragged) to one npz."""
    frames = sorted(problem._frame_data)
    fd = [problem._frame_data[f] for f in frames]
    np.savez_compressed(
        path,
        frames=np.asarray(frames, np.int64),
        counts=np.asarray([len(d.ts_a) for d in fd], np.int64),
        ts_a=np.concatenate([d.ts_a for d in fd]) if fd else np.zeros(0),
        ts_b=np.concatenate([d.ts_b for d in fd]) if fd else np.zeros(0),
        rays_a=np.concatenate([d.rays_a for d in fd]) if fd else np.zeros((0, 3)),
        rays_b=np.concatenate([d.rays_b for d in fd]) if fd else np.zeros((0, 3)),
    )


def load_tracks(problem, path: str) -> int:
    """Feed cached frame data into a SyncProblem via set_track_result.
    Returns the number of frames restored."""
    with np.load(path) as z:  # each z[name] read decompresses the array: read each once
        frames, counts = z["frames"], z["counts"]
        ts_a, ts_b, rays_a, rays_b = z["ts_a"], z["ts_b"], z["rays_a"], z["rays_b"]
    offs = np.concatenate([[0], np.cumsum(counts)])
    for i, f in enumerate(frames):
        s, e = offs[i], offs[i + 1]
        problem.set_track_result(int(f), ts_a[s:e], ts_b[s:e], rays_a[s:e], rays_b[s:e])
    return len(frames)


def tracks_cached_or_compute(problem, cache_dir: str | None, key: str, compute) -> bool:
    """Load tracks from `cache_path(cache_dir, key)` if present, else run
    `compute()` (which must fill `problem`) and save. Returns True on a
    cache hit."""
    if not cache_dir:
        compute()
        return False
    os.makedirs(cache_dir, exist_ok=True)
    path = cache_path(cache_dir, key)
    if os.path.exists(path):
        load_tracks(problem, path)
        return True
    compute()
    save_tracks(problem, path)
    return False
