"""`SyncProblem` — the public engine API, preserving ISyncProblem
semantics (ref: src/core/public/rssync.h:9-31, README.md:62-71).

Method map (reference -> here; snake_case is primary, the reference's
exact CamelCase names are provided as aliases):

  SetGyroQuaternions(data, count, rate, t0) -> set_gyro_quaternions
  SetGyroQuaternions(ts_us, quats, count)   -> set_gyro_quaternions_us
  SetTrackResult                            -> set_track_result
  PreSync                                   -> pre_sync
  Sync                                      -> sync
  DebugPreSync                              -> debug_pre_sync

Times are in seconds except the `_us` variant (microsecond int64).
Quaternions are (count, 4) in (w, x, y, z) order. PreSync/DebugPreSync
take frames in the half-open [begin, end) (ref :66, :343), Sync in the
closed [begin, end] (ref :219).

Every tensor lives on the device given at construction, the card
unless the caller asks for the CPU; asking for CUDA where there is none
raises. Every random draw flows from one seed
through `torch.Generator`s, one per engine call, so identical call
sequences on the same device reproduce.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from rssync_tpu_torch.core import presync as presync_mod
from rssync_tpu_torch.core import sync as sync_mod
from rssync_tpu_torch.core.problem import (
    SplineTable,
    TrackWindow,
    build_track_window,
    make_spline_table,
)
from rssync_tpu_torch.utils.checks import SyncPanic, check_finite, check_monotonic


class _FrameData(NamedTuple):
    ts_a: np.ndarray
    ts_b: np.ndarray
    rays_a: np.ndarray
    rays_b: np.ndarray


_US_IN_SEC = 1_000_000


def resample_quats_us(
    ts: np.ndarray, quats: np.ndarray
) -> tuple[int, np.ndarray, np.ndarray]:
    """Variable-rate resample core (ref: core_private.cpp:142-190):
    mean rate rounded to the nearest 50 Hz, uniform integer-µs grid,
    per-sample SLERP, all integer arithmetic as in the reference (floor
    divisions on µs counts).

    ts: (n,) int64 µs. quats: (..., n, 4) f64, leading axes batch.
    Returns (rate_hz, grid_ts (m,), quats (..., m, 4)).
    """
    count = ts.shape[0]
    check_monotonic("set-gyro-quaternions", ts)

    # mean rate in µHz, rounded to nearest 50 Hz (ref :146-149)
    actual_sr_uhz = (1_000_000 * _US_IN_SEC * count) // int(ts[-1] - ts[0])
    rounded_sr_hz = int(round(actual_sr_uhz / 50.0 / 1_000_000) * 50)

    # uniform grid of integer-µs timestamps (ref :151-155). The
    # reference's std::ceil runs after an integer division, so it is a
    # no-op: the grid starts one sample earlier than a true ceiling
    # whenever ts[0]*sr % 1e6 != 0.
    first_sample = int(ts[0]) * rounded_sr_hz // _US_IN_SEC
    # closed-form count of grid samples with floor-µs timestamps below
    # ts[-1] (identical to the reference's increment loop)
    last_excl = (int(ts[-1]) * rounded_sr_hz + _US_IN_SEC - 1) // _US_IN_SEC
    s = np.arange(first_sample, max(first_sample, last_excl), dtype=np.int64)
    new_ts = _US_IN_SEC * s // rounded_sr_hz
    new_ts = new_ts[new_ts < ts[-1]]

    # bracketing indices + SLERP (ref :166-182)
    idx = np.searchsorted(ts, new_ts, side="left")
    lo = np.maximum(idx - 1, 0)
    hi = np.minimum(idx, count - 1)
    denom = (ts[hi] - ts[lo]).astype(np.float64)
    t = np.where(
        denom > 0, (new_ts - ts[lo]) / np.where(denom > 0, denom, 1.0), 0.0
    )
    # idx == 0 -> take sample 0 directly (ref :178-180)
    t = np.where(idx > 0, t, 0.0)
    new_q = _slerp64(quats[..., lo, :], quats[..., hi, :], t)
    return rounded_sr_hz, new_ts, new_q


def _slerp64(p: np.ndarray, q: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Host f64 SLERP with antipodal flip and small-angle lerp fallback
    (ref quat.cpp:55-74)."""
    t = np.broadcast_to(np.asarray(t, np.float64), p.shape[:-1])[..., None]
    d = np.sum(p * q, axis=-1, keepdims=True)
    q = np.where(d < 0.0, -q, q)
    d = np.abs(d)
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    sin_theta = np.sin(theta)
    big = theta > 1e-9
    safe_sin = np.where(big, sin_theta, 1.0)
    m1 = np.where(big, np.sin((1.0 - t) * theta) / safe_sin, 1.0 - t)
    m2 = np.where(big, np.sin(t * theta) / safe_sin, t)
    return m1 * p + m2 * q


class SyncProblem:
    """One gyro-to-video synchronization problem instance on `device`."""

    def __init__(self, seed: int = 0, *, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"SyncProblem: {self.device} requested but CUDA is not available")
        # the seed stream lives on the host; each engine call gets a
        # fresh generator on the device seeded from it
        self._seeds = torch.Generator().manual_seed(int(seed))
        self._table: SplineTable | None = None
        self._quats_start: float = 0.0
        self._sample_rate: float = 0.0
        self._frame_data: Dict[int, _FrameData] = {}
        self._window_cache: dict = {}

    # -- RNG ----------------------------------------------------------------
    def next_generator(self) -> torch.Generator:
        """The next engine generator (deterministic sequence per seed)."""
        seed = int(torch.randint(0, 2**62, (1,), generator=self._seeds))
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- gyro intake --------------------------------------------------------
    def set_gyro_quaternions(
        self, quats: np.ndarray, sample_rate: float, first_timestamp: float
    ) -> None:
        """Fixed-rate intake (ref: core_private.cpp:135-140): quats
        (count, 4) wxyz at `sample_rate` Hz from `first_timestamp` s."""
        quats = np.ascontiguousarray(np.asarray(quats, np.float64))
        if quats.ndim != 2 or quats.shape[1] != 4:
            raise ValueError("quats must be (count, 4) wxyz")
        self._sample_rate = float(sample_rate)
        self._quats_start = float(first_timestamp)
        self._table = make_spline_table(quats, sample_rate, device=self.device)
        self._window_cache.clear()

    def set_gyro_quaternions_us(
        self, timestamps_us: np.ndarray, quats: np.ndarray
    ) -> None:
        """Variable-rate intake: estimate the mean rate, round to the
        nearest 50 Hz, resample by SLERP onto a uniform integer-µs grid,
        then fit (ref: core_private.cpp:142-190)."""
        ts = np.asarray(timestamps_us, np.int64)
        q = np.asarray(quats, np.float64).reshape(-1, 4)
        if q.shape[0] != ts.shape[0]:
            raise ValueError("timestamps/quats length mismatch")
        rounded_sr_hz, new_ts, new_q = resample_quats_us(ts, q)
        check_finite("set-gyro-quaternions: sample after interpolation", new_q)

        self._sample_rate = float(rounded_sr_hz)
        self._quats_start = float(new_ts[0]) / _US_IN_SEC
        check_finite("sample rate", [self._sample_rate])
        check_finite("first timestamp", [self._quats_start])
        self._table = make_spline_table(new_q, self._sample_rate, device=self.device)
        self._window_cache.clear()

    # -- track intake -------------------------------------------------------
    def set_track_result(
        self, frame: int, ts_a: np.ndarray, ts_b: np.ndarray,
        rays_a: np.ndarray, rays_b: np.ndarray,
    ) -> None:
        """Per-frame correspondences (ref: core_private.cpp:192-203):
        ts_a/ts_b (n,) per-ray rolling-shutter-corrected timestamps in
        seconds, rays_a/rays_b (n, 3) unit observation rays."""
        fd = _FrameData(
            ts_a=np.ascontiguousarray(ts_a, np.float64),
            ts_b=np.ascontiguousarray(ts_b, np.float64),
            rays_a=np.ascontiguousarray(np.asarray(rays_a, np.float64).reshape(-1, 3)),
            rays_b=np.ascontiguousarray(np.asarray(rays_b, np.float64).reshape(-1, 3)),
        )
        check_finite("rays_a", fd.rays_a)
        check_finite("rays_b", fd.rays_b)
        check_finite("ts_a", fd.ts_a)
        check_finite("ts_b", fd.ts_b)
        self._frame_data[int(frame)] = fd
        self._window_cache.clear()

    # -- window assembly ----------------------------------------------------
    def _require_gyro(self) -> SplineTable:
        if self._table is None:
            raise RuntimeError("SetGyroQuaternions must be called first")
        return self._table

    def build_window(
        self, frame_begin: int, frame_end: int, closed: bool = False
    ) -> TrackWindow:
        """Padded window tensors for frames in [begin, end) (closed=False,
        PreSync convention) or [begin, end] (closed=True, Sync), cached
        until the next intake."""
        key = (frame_begin, frame_end, closed)
        cached = self._window_cache.get(key)
        if cached is not None:
            return cached
        last = frame_end if closed else frame_end - 1
        frames = sorted(f for f in self._frame_data if frame_begin <= f <= last)
        if not frames:
            raise RuntimeError(
                f"no track data for frames [{frame_begin}, {frame_end}"
                + ("]" if closed else ")")
            )
        fds = [self._frame_data[f] for f in frames]
        win = build_track_window(
            [fd.ts_a for fd in fds],
            [fd.ts_b for fd in fds],
            [fd.rays_a for fd in fds],
            [fd.rays_b for fd in fds],
            quats_start=self._quats_start,
            sample_rate=self._sample_rate,
            device=self.device,
        )
        self._window_cache[key] = win
        return win

    @property
    def spline_table(self) -> SplineTable:
        return self._require_gyro()

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self.device)

    # -- engine calls -------------------------------------------------------
    def pre_sync(
        self, initial_delay: float, frame_begin: int, frame_end: int,
        search_step: float, search_radius: float,
    ) -> tuple[float, float]:
        """Brute-force coarse search; returns (min cost, argmin delay)
        (ref: core_private.cpp:61-90, 205-209), over the reference's
        f64-accumulated grid."""
        table = self._require_gyro()
        win = self.build_window(frame_begin, frame_end, closed=False)
        delays = self._f32(
            presync_mod.presync_grid(initial_delay, search_radius, search_step)
        )
        with torch.no_grad():
            costs = presync_mod.presync_scan(table, win, delays, self.next_generator())
        cost, delay = presync_mod.presync_best(costs, delays)
        return float(cost), float(delay)

    def sync(
        self, initial_delay: float, frame_begin: int, frame_end: int,
        search_center: float = np.nan, search_radius: float = np.inf,
    ) -> tuple[float, float]:
        """Fine alternating optimization; returns (cost, delay)
        (ref: core_private.cpp:211-334)."""
        table = self._require_gyro()
        win = self.build_window(frame_begin, frame_end, closed=True)
        center = initial_delay if np.isnan(search_center) else search_center
        res = sync_mod.sync_window(
            table, win, initial_delay, center, search_radius, self.next_generator()
        )
        return float(res.cost), float(res.delay)

    def debug_pre_sync(
        self, initial_delay: float, frame_begin: int, frame_end: int,
        search_radius: float, point_count: int,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Loss-surface export: `point_count` delays spanning
        initial +- radius inclusive (ref: core_private.cpp:336-361).
        Returns (delays, costs) arrays."""
        if point_count < 2:
            # the reference divides by (point_count - 1) with integer
            # arithmetic (ref :345): point_count=1 is 0/0, a crash there
            raise SyncPanic(
                f"debug-pre-sync: point_count must be >= 2, got {point_count}"
            )
        table = self._require_gyro()
        win = self.build_window(frame_begin, frame_end, closed=False)
        i = np.arange(point_count, dtype=np.float64)
        delays = initial_delay - search_radius + 2.0 * search_radius * i / (
            point_count - 1
        )
        with torch.no_grad():
            costs = presync_mod.presync_scan(
                table, win, self._f32(delays), self.next_generator()
            )
        return delays, costs.double().cpu().numpy()

    # -- reference-exact aliases -------------------------------------------
    def SetGyroQuaternions(self, *args):
        """Dispatch both reference overloads by argument pattern."""
        if len(args) == 3:
            return self.set_gyro_quaternions(*args)
        if len(args) == 2:
            return self.set_gyro_quaternions_us(*args)
        raise TypeError("SetGyroQuaternions takes (quats, rate, t0) or (ts_us, quats)")

    def SetTrackResult(self, frame, ts_a, ts_b, rays_a, rays_b):
        return self.set_track_result(frame, ts_a, ts_b, rays_a, rays_b)

    def PreSync(self, initial_delay, frame_begin, frame_end, search_step, search_radius):
        return self.pre_sync(initial_delay, frame_begin, frame_end, search_step, search_radius)

    def Sync(self, initial_delay, frame_begin, frame_end,
             search_center=np.nan, search_radius=np.inf):
        return self.sync(initial_delay, frame_begin, frame_end, search_center, search_radius)

    def DebugPreSync(self, initial_delay, frame_begin, frame_end, search_radius, point_count):
        return self.debug_pre_sync(
            initial_delay, frame_begin, frame_end, search_radius, point_count)


def create_sync_problem(seed: int = 0, *, device="cuda") -> SyncProblem:
    """Factory mirroring `CreateSyncProblem()` (ref: core_private.cpp:363)."""
    return SyncProblem(seed=seed, device=device)
