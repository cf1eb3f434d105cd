"""Vectorized synthetic engine problems (rays + gyro log) with a known
delay — no video involved. Builds reference-operating-point workloads
(60-frame windows, ~130 features, 200 Hz gyro) in a second on the host.

For one seed the arrays are exactly those of
rssync_tpu/testing/engine_problem.py (the same numpy draws in the same
order). The problem keeps the host arrays, so a caller can feed a
`SyncProblem` through its public methods (`feed`) or build the device
tensors directly (`table`, `windows`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.spatial.transform import Rotation

from rssync_tpu_torch.core.problem import (
    SplineTable,
    TrackWindow,
    build_track_window,
    make_spline_table,
)

#: the engine's reference operating point (bench.py, BASELINE.md): a 60 s
#: clip at 60 fps, 130 features, 30 windows of 60 frames every 120
#: frames, PreSync over +-200 ms in 2 ms steps
OPERATING_POINT = dict(seed=0, duration=60.0, fps=60.0, n_features=130,
                       sync_window=60, syncpoint_distance=120, true_delay=0.0423)
PRESYNC_RADIUS_MS, PRESYNC_STEP_MS = 200.0, 2.0


@dataclass
class EngineProblem:
    #: (n, 4) wxyz gyro orientation samples
    quats: np.ndarray
    gyro_rate: float
    #: timestamp of quats[0], seconds
    quats_start: float
    #: per window: (t_a, t_b) (F, N) timestamps and (rays_a, rays_b)
    #: (F, N, 3); row j is the pair (syncpoint + j, syncpoint + j + 1)
    tracks: list
    syncpoints: list[int]
    true_delay: float
    fps: float
    sync_window: int
    #: ground-truth delay as a function of video time (seconds); equals
    #: the constant `true_delay` unless delay_drift/delay_curve are set
    delay_at: object = None

    def table(self, device) -> SplineTable:
        return make_spline_table(self.quats, self.gyro_rate, device=device)

    def windows(self, device) -> list[TrackWindow]:
        return [
            build_track_window(
                list(t_a), list(t_b), list(ra), list(rb),
                quats_start=self.quats_start, sample_rate=self.gyro_rate,
                device=device,
            )
            for t_a, t_b, ra, rb in self.tracks
        ]

    def frames(self):
        """(frame, ts_a, ts_b, rays_a, rays_b) for every tracked frame."""
        for sp, (t_a, t_b, ra, rb) in zip(self.syncpoints, self.tracks):
            for j in range(t_a.shape[0]):
                yield sp + j, t_a[j], t_b[j], ra[j], rb[j]

    def feed(self, problem) -> None:
        """Hand the gyro log and every frame's tracks to a SyncProblem
        through its public intake methods."""
        if any(b - a < self.sync_window for a, b in zip(self.syncpoints, self.syncpoints[1:])):
            raise ValueError("overlapping windows track one frame twice")
        problem.set_gyro_quaternions(self.quats, self.gyro_rate, self.quats_start)
        for f, ts_a, ts_b, ra, rb in self.frames():
            problem.set_track_result(f, ts_a, ts_b, ra, rb)


def _angles(t, seed, amp=0.35):
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(0.3, 1.6, size=(3, 3))
    phases = rng.uniform(0, 2 * np.pi, size=(3, 3))
    amps = rng.uniform(0.3, 1.0, size=(3, 3)) * amp
    t = np.asarray(t)[..., None]
    return np.stack(
        [
            (amps[i] * np.sin(2 * np.pi * freqs[i] * t + phases[i])).sum(-1)
            for i in range(3)
        ],
        axis=-1,
    )


def make_engine_problem(
    seed: int = 0,
    duration: float = 60.0,
    fps: float = 60.0,
    n_features: int = 130,
    gyro_rate: float = 200.0,
    sync_window: int = 60,
    syncpoint_distance: int = 120,
    readout: float = 0.01111,
    true_delay: float = 0.0423,
    noise: float = 2e-4,
    pad: float = 1.0,
    delay_drift: float = 0.0,
    delay_curve: float = 0.0,
) -> EngineProblem:
    """Reference-recipe-shaped workload (60-frame windows every 120
    frames, 11.11 ms readout, 200 Hz gyro by default). Rays are exact
    pure-rotation correspondences plus isotropic angular noise."""
    rng = np.random.default_rng(seed)
    n_frames = int(duration * fps)

    def delay_at(t):
        # slowly drifting gyro clock: d(t) = d0 + drift*t + curve*t^2
        t = np.asarray(t, np.float64)
        return true_delay + delay_drift * t + delay_curve * t * t

    # gyro log: orientation at gyro-clock tau comes from video time
    # tau - d(tau); the log starts pad seconds before frame 0
    n_g = int((duration + 2 * pad) * gyro_rate)
    tau = np.arange(n_g) / gyro_rate - pad
    ang = _angles(tau - delay_at(tau), seed)
    quats_rot = Rotation.from_euler("ZYX", ang[:, ::-1]).inv()
    q = quats_rot.as_quat()  # xyzw
    quats = np.concatenate([q[:, 3:4], q[:, :3]], axis=1)
    quats_start = float(tau[0])

    syncpoints = []
    pos = 0
    while pos + sync_window < n_frames:
        syncpoints.append(pos)
        pos += syncpoint_distance

    tracks = []
    row01 = rng.uniform(0, 1, size=(len(syncpoints), sync_window, n_features))
    row01_b = np.clip(
        row01 + rng.normal(0, 0.02, row01.shape), 0, 1
    )  # tracked row moves slightly
    for wi, sp_pos in enumerate(syncpoints):
        f_idx = sp_pos + np.arange(sync_window + 1)  # closed window frames
        t_a = f_idx[:-1, None] / fps + readout * row01[wi]
        t_b = f_idx[1:, None] / fps + readout * row01_b[wi]
        # world directions in a forward cone, new draw per frame
        d = rng.normal(size=(sync_window, n_features, 3)) * [0.45, 0.45, 0.12]
        d[..., 2] += 1.0
        d /= np.linalg.norm(d, axis=-1, keepdims=True)

        def cam_rays(ts, dirs):
            R = Rotation.from_euler(
                "ZYX", _angles(ts.reshape(-1), seed)[:, ::-1]
            )
            out = R.inv().apply(dirs.reshape(-1, 3))
            if noise > 0:
                out = out + rng.normal(0, noise, out.shape)
                out /= np.linalg.norm(out, axis=-1, keepdims=True)
            return out.reshape(dirs.shape)

        rays_a = cam_rays(t_a, d)
        rays_b = cam_rays(t_b, d)
        tracks.append((t_a, t_b, rays_a, rays_b))

    return EngineProblem(
        quats=quats,
        gyro_rate=gyro_rate,
        quats_start=quats_start,
        tracks=tracks,
        syncpoints=syncpoints,
        true_delay=true_delay,
        fps=fps,
        sync_window=sync_window,
        delay_at=delay_at,
    )
