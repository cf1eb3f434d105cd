"""Sync-quality metric: RMSE of per-window delays against a linear
delay-drift model, the reference's accuracy measure
(ref: python/plot_sync.py:19-50). A copy of rssync_tpu/analysis/metrics.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SyncQuality:
    slope: float       # delay drift per frame
    intercept: float   # delay at frame 0
    rmse: float        # std of (fit - measured), the headline number
    residuals: np.ndarray


def sync_rmse(frames: np.ndarray, delays_ms: np.ndarray) -> SyncQuality:
    """Least-squares line through (frame, delay) pairs; RMSE =
    std(fit - measured), as plot_sync.py:44-50 computes it."""
    frames = np.asarray(frames, np.float64)
    delays_ms = np.asarray(delays_ms, np.float64)
    A = np.stack([frames, np.ones_like(frames)], axis=1)
    (slope, intercept), *_ = np.linalg.lstsq(A, delays_ms, rcond=None)
    fit = intercept + slope * frames
    resid = fit - delays_ms
    return SyncQuality(
        slope=float(slope),
        intercept=float(intercept),
        rmse=float(np.std(resid)),
        residuals=resid,
    )


def to_gyroflow_offset(delay_s, readout_s):
    """Convert an engine delay (seconds) to the value entered in
    GyroFlow's manual "Gyro offset" field: the sign flips, plus a
    +readout/2 frame-center convention shift (thesis p.15/p.32: for the
    Hero-6's 11.11 ms readout the shift is +5.555 ms). `readout_s` is the
    lens profile's `ro`, the full-frame rolling-shutter readout time in
    seconds. Array-friendly: numpy broadcasts both arguments.

    The sign flip is the thesis's convention and has not been checked
    against GyroFlow itself (no GyroFlow build or real footage was at
    hand); confirm it on a clip before relying on it."""
    return -np.asarray(delay_s, np.float64) + np.asarray(readout_s, np.float64) / 2.0


def sync_rmse_from_csv(path: str) -> SyncQuality:
    """Metric over a `<frame>,<delay_ms>` sync CSV (the driver's output
    format, ref core_testcode.cpp:315)."""
    data = np.loadtxt(path, delimiter=",", ndmin=2)
    return sync_rmse(data[:, 0], data[:, 1])
