"""A rolling-shutter clip with a known delay, rendered on the device:
a frozen copy of the port's `testing/synthvideo.py` renderer and gyro
log that renders only the frames it is asked for.

Plain torch, numpy and scipy; it imports nothing of the program under
test, so a later change to the program cannot change the benchmark's
inputs. For one seed, `render_frames(..., indices)` gives frames
bit-equal to `make_clip`'s frames at those indices, and `gyro_log`
gives its gyro log (tests/test_gen.py holds both on the CPU).

Scene: a camera with Kannala-Brandt fisheye optics rotates along a
smooth Euler-angle sinusoid while observing a procedural 3-D texture
(a sum of random-frequency sinusoids of the view direction). Each image
row is rendered at its own rolling-shutter timestamp f / fps + readout
* row / height. The gyro log holds the +body rates of that rotation;
the orientation string "xyz" makes it consistent for the engine, whose
delay against the frame timestamps is then true_delay + pad / 2 (plus
drift times the video time, when the log's clock drifts).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy.spatial.transform import Rotation

_F32 = torch.float32


@dataclass(frozen=True)
class LensParams:
    """Kannala-Brandt lens: readout (s), intrinsics (px), k1..k4."""

    ro: float
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float
    k2: float
    k3: float
    k4: float


def hero6_lens(width: int, height: int, readout: float) -> LensParams:
    """The hero6-like lens of `make_clip`, intrinsics scaled to the
    render size."""
    s = width / 2704.0
    return LensParams(ro=readout, fx=1186.0 * s, fy=1186.0 * s,
                      cx=width * 0.5012, cy=height * 0.5033,
                      k1=0.0444, k2=0.0195, k3=-0.00448, k4=-0.00204)


def trajectory_params(seed: int, n_modes: int = 3, amp: float = 0.12):
    """(freqs, phases, amps), each (3, n_modes): the Euler-angle
    sinusoid of `seed`."""
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(0.3, 1.8, size=(3, n_modes))
    phases = rng.uniform(0, 2 * np.pi, size=(3, n_modes))
    amps = rng.uniform(0.3, 1.0, size=(3, n_modes)) * amp
    return freqs, phases, amps


def _euler_trajectory(seed: int, n_modes: int = 3, amp: float = 0.12):
    freqs, phases, amps = trajectory_params(seed, n_modes, amp)

    def angles(t: torch.Tensor) -> torch.Tensor:
        """(..., 3) roll, pitch, yaw at times t (float32 tensor)."""
        t = t[..., None]

        def c(x):
            return torch.as_tensor(x, dtype=_F32, device=t.device)

        return torch.stack(
            [
                torch.sum(c(amps[i]) * torch.sin(c(2 * np.pi * freqs[i]) * t + c(phases[i])),
                          dim=-1)
                for i in range(3)
            ],
            dim=-1,
        )

    return angles


def _euler_to_matrix(ang: torch.Tensor) -> torch.Tensor:
    """Rz(yaw) @ Ry(pitch) @ Rx(roll), batched; ang (..., 3)."""
    r, p, y = ang[..., 0], ang[..., 1], ang[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], -1)
    return torch.stack([row0, row1, row2], -2)


def _texture(dirs: torch.Tensor, seed: int, n_waves: int = 24) -> torch.Tensor:
    rng = np.random.default_rng(seed + 1000)
    scales = np.exp(rng.uniform(np.log(4.0), np.log(220.0), size=n_waves))
    axes = rng.normal(size=(n_waves, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    dev = dirs.device
    freqs = torch.as_tensor(axes * scales[:, None], dtype=_F32, device=dev)
    phases = torch.as_tensor(rng.uniform(0, 2 * np.pi, n_waves), dtype=_F32, device=dev)
    amps = torch.as_tensor(1.0 / np.sqrt(scales), dtype=_F32, device=dev)
    v = torch.matmul(dirs, freqs.T) + phases
    val = torch.matmul(torch.sin(v), amps)
    val = val / torch.sum(amps)
    return (0.5 + 0.5 * torch.tanh(2.5 * val)) * 255.0


def _coef(k: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(k, dtype=torch.float64).to(dtype))


def _distort_theta(theta, k1, k2, k3, k4):
    t2 = theta * theta
    return theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))


def _undistort_points(lens: LensParams, pts: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> normalized image plane, as the renderer of
    `make_clip` computes its camera rays (9 Newton steps with a halving
    safeguard, in the points' dtype)."""
    dtype = pts.dtype
    x_ = (pts[..., 0] - lens.cx) / lens.fx
    y_ = (pts[..., 1] - lens.cy) / lens.fy
    theta_d = torch.sqrt(x_ * x_ + y_ * y_)
    k1, k2, k3, k4 = (_coef(k, dtype) for k in (lens.k1, lens.k2, lens.k3, lens.k4))
    d3, d5, d7, d9 = (_coef(c * k, dtype) for c, k in ((3.0, k1), (5.0, k2), (7.0, k3), (9.0, k4)))
    half_pi = _coef(np.pi / 2.0, dtype)
    theta = torch.full_like(theta_d, np.pi / 4.0)
    for _ in range(9):
        t2 = theta * theta
        t4 = t2 * t2
        t6 = t4 * t2
        t8 = t4 * t4
        cur = _distort_theta(theta, k1, k2, k3, k4)
        dcur = 1.0 + d3 * t2 + d5 * t4 + d7 * t6 + d9 * t8
        new_theta = theta - (cur - theta_d) / dcur
        for _ in range(40):
            bad = (new_theta >= half_pi) | (new_theta <= 0.0)
            new_theta = torch.where(bad, 0.5 * (new_theta + theta), new_theta)
        theta = new_theta
    r = torch.tan(theta)
    inv_cos = 1.0 / torch.cos(theta)
    s = torch.where(theta_d < 1e-9, inv_cos, r / torch.clamp(theta_d, min=1e-30))
    out = torch.stack([x_ * s, y_ * s], dim=-1)
    raw_zero = torch.linalg.vector_norm(pts, dim=-1, keepdim=True) < 1e-8
    return torch.where(raw_zero, torch.zeros_like(out), out)


def _rays_from_normalized(xy: torch.Tensor) -> torch.Tensor:
    v = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def camera_rays(lens: LensParams, width: int, height: int, device) -> torch.Tensor:
    """(H, W, 3) float32 unit ray of every pixel."""
    vv, uu = torch.meshgrid(
        torch.arange(height, dtype=torch.float64), torch.arange(width, dtype=torch.float64),
        indexing="ij",
    )
    pix = torch.stack([uu, vv], dim=-1).to(_F32).to(device)
    return _rays_from_normalized(_undistort_points(lens, pix))


def render_frames(seed: int, indices, fps: float, width: int, height: int,
                  readout: float, device, lens: LensParams | None = None) -> torch.Tensor:
    """Frames `indices` of the clip of `seed`: (len(indices), H, W) uint8
    on `device`. Frame f is rendered row by row at f / fps + readout *
    row / height."""
    dev = torch.device(device)
    lens = lens or hero6_lens(width, height, readout)
    cam_rays = camera_rays(lens, width, height, dev)
    out = torch.empty((len(indices), height, width), dtype=torch.uint8, device=dev)
    angles_of = _euler_trajectory(seed)
    row_frac = np.arange(height) / height
    for i, f in enumerate(indices):
        row_times = torch.as_tensor(f / fps + readout * row_frac, dtype=_F32, device=dev)
        R = _euler_to_matrix(angles_of(row_times))  # (H, 3, 3) camera -> world
        world = torch.einsum("hij,hwj->hwi", R, cam_rays)
        out[i] = _texture(world, seed).to(torch.uint8)
    return out


def gyro_log(seed: int, duration: float, true_delay: float, pad: float,
             gyro_rate: float, drift: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """(timestamps (n,) s, +body rates (n, 3) rad/s) on the gyro clock of
    a clip `duration` s long: the log starts pad / 2 before frame 0 and
    gyro time tau is render time (tau - (true_delay + pad / 2)) /
    (1 + drift), so the delay at render time t is true_delay + pad / 2 +
    drift * t (`make_clip`'s log at drift 0)."""
    n_g = int((duration + pad) * gyro_rate)
    tau = np.arange(n_g) / gyro_rate
    t_video = torch.as_tensor((tau - (true_delay + pad / 2)) / (1.0 + drift), dtype=_F32)
    ang = _euler_trajectory(seed)(t_video).double().numpy()
    Rm = Rotation.from_euler("ZYX", ang[:, ::-1])
    rel = Rm[:-1].inv() * Rm[1:]
    omega = rel.as_rotvec() * gyro_rate
    omega = np.concatenate([[omega[0]], omega])
    return tau, omega
