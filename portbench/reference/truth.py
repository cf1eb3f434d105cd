"""The plain reference: what a perfect tracker and a perfect sync return
on the rendered clip, worked out from the scene itself.

The clip is a pure rotation seen through a Kannala-Brandt lens, each
row exposed at its own rolling-shutter time, so both answers are known
in closed form:

- a grid point p of frame a shows the world direction
  w = R(t_a) ray(p), t_a = a / fps + readout * p_y / height; it appears in
  frame b = a + 1 at the pixel q with R(t_b) ray(q) = w,
  t_b = b / fps + readout * q_y / height, which a fixed-point iteration
  on q_y finds;
- the delay at a syncpoint is the gyro time of its window's middle
  instant minus that instant's video time (the clocks drift apart at a
  constant rate).

Everything here is plain elementwise torch in one dtype (float64 for
the reference, bfloat16 for the control) with no matrix product, so no
TF32 path exists. It imports nothing of the program under test and
takes nothing the program made: only the configuration, the seed and
the frame indices.
"""

from __future__ import annotations

import numpy as np
import torch

#: fixed-point steps of the rolling-shutter row of q (each shrinks the
#: row's error by readout * |row speed| / height, well under 1e-2)
RS_STEPS = 8
#: Newton steps of the reference's own lens inversion
NEWTON_STEPS = 30


def grid_points(width: int, height: int, step: int) -> np.ndarray:
    """The tracking grid: x-major from (step, step), (N, 2)."""
    return np.asarray([[float(x), float(y)] for x in range(step, width, step)
                       for y in range(step, height, step)], np.float64)


def _angles(traj, t: torch.Tensor) -> torch.Tensor:
    """(..., 3) roll, pitch, yaw of the trajectory (freqs, phases, amps)
    at times t, in t's dtype."""
    freqs, phases, amps = traj
    out = []
    for i in range(3):
        a = torch.zeros_like(t)
        for m in range(freqs.shape[1]):
            w = torch.tensor(2 * np.pi * freqs[i, m], dtype=t.dtype)
            ph = torch.tensor(phases[i, m], dtype=t.dtype)
            amp = torch.tensor(amps[i, m], dtype=t.dtype)
            a = a + amp * torch.sin(w * t + ph)
        out.append(a)
    return torch.stack(out, -1)


def _rotate(ang: torch.Tensor, v: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """R v (or R^T v) for R = Rz(yaw) Ry(pitch) Rx(roll), elementwise."""
    r, p, y = ang[..., 0], ang[..., 1], ang[..., 2]
    cr, sr, cp, sp, cy, sy = (torch.cos(r), torch.sin(r), torch.cos(p), torch.sin(p),
                              torch.cos(y), torch.sin(y))
    R = [[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
         [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
         [-sp, cp * sr, cp * cr]]
    x = [v[..., 0], v[..., 1], v[..., 2]]
    if inverse:
        rows = [R[0][i] * x[0] + R[1][i] * x[1] + R[2][i] * x[2] for i in range(3)]
    else:
        rows = [R[i][0] * x[0] + R[i][1] * x[1] + R[i][2] * x[2] for i in range(3)]
    return torch.stack(rows, -1)


def undistort_ray(lens: dict, pts: torch.Tensor) -> torch.Tensor:
    """Unit camera rays of pixels (..., 2): Newton on the lens's theta
    polynomial from theta_d, in the points' dtype."""
    dt = pts.dtype
    k1, k2, k3, k4 = (torch.tensor(lens[k], dtype=dt) for k in ("k1", "k2", "k3", "k4"))
    x = (pts[..., 0] - lens["cx"]) / lens["fx"]
    y = (pts[..., 1] - lens["cy"]) / lens["fy"]
    theta_d = torch.sqrt(x * x + y * y)
    theta = theta_d.clone()
    for _ in range(NEWTON_STEPS):
        t2 = theta * theta
        f = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - theta_d
        df = 1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        theta = torch.clamp(theta - f / df, 0.0, 1.5)
    s = torch.where(theta_d > 1e-12, torch.tan(theta) / torch.clamp(theta_d, min=1e-12),
                    torch.ones_like(theta))
    v = torch.stack([x * s, y * s, torch.ones_like(x)], -1)
    return v / torch.sqrt((v * v).sum(-1, keepdim=True))


def distort_ray(lens: dict, ray: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) of camera rays (..., 3) in front of the lens."""
    dt = ray.dtype
    k1, k2, k3, k4 = (torch.tensor(lens[k], dtype=dt) for k in ("k1", "k2", "k3", "k4"))
    x, y = ray[..., 0] / ray[..., 2], ray[..., 1] / ray[..., 2]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan(r)
    t2 = theta * theta
    td = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    s = torch.where(r > 1e-12, td / torch.clamp(r, min=1e-12), torch.ones_like(r))
    return torch.stack([x * s * lens["fx"] + lens["cx"], y * s * lens["fy"] + lens["cy"]], -1)


def true_tracks(traj, lens: dict, grid: np.ndarray, frames_a: np.ndarray, fps: float,
                height: int, dtype=torch.float64) -> torch.Tensor:
    """(P, N, 2) true positions in frame a + 1 of the N grid points of
    each frame a in `frames_a` (P,), computed in `dtype` on the CPU."""
    ro = torch.tensor(lens["ro"], dtype=dtype)
    g = torch.as_tensor(grid, dtype=dtype)  # (N, 2)
    fa = torch.as_tensor(np.asarray(frames_a, np.float64), dtype=dtype)[:, None]  # (P, 1)
    inv_fps = torch.tensor(1.0 / fps, dtype=dtype)
    t_a = fa * inv_fps + ro * g[None, :, 1] / height  # (P, N)
    world = _rotate(_angles(traj, t_a), undistort_ray(lens, g)[None].expand(*t_a.shape, 3))
    q_y = g[None, :, 1].expand_as(t_a)
    for _ in range(RS_STEPS):
        t_b = (fa + 1) * inv_fps + ro * q_y / height
        q = distort_ray(lens, _rotate(_angles(traj, t_b), world, inverse=True))
        q_y = q[..., 1]
    return q


def tracked_pixels(lens: dict, rays_b: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) the program tracked, from the rays (..., 3) it
    emitted (float64)."""
    return distort_ray(lens, rays_b.to(torch.float64))


def window_delays(syncpoint_frames: np.ndarray, fps: float, window: int, delay0: float,
                  drift: float, dtype=torch.float64) -> torch.Tensor:
    """(W,) delay of each syncpoint's window: the gyro time of the
    window's middle instant minus its video time, where gyro time is
    video time t plus delay0 + drift * t; in `dtype`."""
    mid = (np.asarray(syncpoint_frames, np.float64) + (window + 1) / 2) / fps
    t_video = torch.as_tensor(mid, dtype=dtype)
    t_gyro = (t_video + torch.tensor(delay0, dtype=dtype)
              + torch.tensor(drift, dtype=dtype) * t_video)
    return t_gyro - t_video
