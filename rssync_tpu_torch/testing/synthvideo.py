"""Synthetic rolling-shutter video + gyro log with a known delay,
rendered on the device.

Port of rssync_tpu/testing/synthvideo.py: the frames come back as a
(T, H, W) uint8 tensor and the gyro log as arrays; `write_clip_files`
writes the MP4 (cv2's mp4v writer), the .gcsv and the lens file in the
layout rssync_tpu's `make_clip` writes them, for the recipe pipeline.
For one seed the trajectory, texture, lens and gyro rates are those of
rssync_tpu's `make_clip`.

Scene: a camera with Kannala-Brandt fisheye optics rotates along a
smooth Euler-angle sinusoid while observing a procedural 3-D texture
(a sum of random-frequency sinusoids of the view direction). Each image
row is rendered at its own rolling-shutter timestamp.

Clock and sign conventions: the integration q_i = quat_from_aa(omega_i
dt) * q_{i-1} (ref core_testcode.cpp:41-46) with the engine applying
conj(q) to camera rays is minimized at the true delay when the logged
rates are the NEGATED body rates. The log holds +body rates, and the
orientation string "xyz" (all axes negated) makes it consistent, as for
a physical gyro whose convention the user has to name.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from rssync_tpu_torch.ops import lens as lens_ops

_F32 = torch.float32


@dataclass
class ClipFiles:
    video_path: str
    gyro_path: str
    lens_path: str
    lens_name: str


@dataclass
class SyntheticClip:
    #: (T, H, W) uint8 frames on the render device
    frames: torch.Tensor
    #: (T,) frame timestamps, seconds on the video clock
    frame_ts: np.ndarray
    #: (n,) gyro sample timestamps, seconds on the gyro clock
    gyro_ts: np.ndarray
    #: (n, 3) gyro rates, rad/s (+body rates; see `orient`)
    gyro_rates: np.ndarray
    lens: lens_ops.Lens
    #: the delay the engine should recover, seconds
    true_delay: float
    fps: float
    n_frames: int
    width: int
    height: int
    gyro_rate: float
    #: orientation string that makes the gyro log consistent
    orient: str


def _euler_trajectory(seed: int, n_modes: int = 3, amp: float = 0.12):
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(0.3, 1.8, size=(3, n_modes))
    phases = rng.uniform(0, 2 * np.pi, size=(3, n_modes))
    amps = rng.uniform(0.3, 1.0, size=(3, n_modes)) * amp

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
    return torch.stack([row0, row1, row2], -2)  # (..., 3, 3)


def _texture(dirs: torch.Tensor, seed: int, n_waves: int = 24) -> torch.Tensor:
    rng = np.random.default_rng(seed + 1000)
    scales = np.exp(rng.uniform(np.log(4.0), np.log(220.0), size=n_waves))
    axes = rng.normal(size=(n_waves, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    dev = dirs.device
    freqs = torch.as_tensor(axes * scales[:, None], dtype=_F32, device=dev)  # (K, 3)
    phases = torch.as_tensor(rng.uniform(0, 2 * np.pi, n_waves), dtype=_F32, device=dev)
    amps = torch.as_tensor(1.0 / np.sqrt(scales), dtype=_F32, device=dev)
    v = torch.matmul(dirs, freqs.T) + phases
    val = torch.matmul(torch.sin(v), amps)
    val = val / torch.sum(amps)
    return (0.5 + 0.5 * torch.tanh(2.5 * val)) * 255.0


def _render_rows(row_times: torch.Tensor, cam_rays: torch.Tensor, seed: int,
                 n_modes: int = 3) -> torch.Tensor:
    """Render one frame: row_times (H,) seconds; cam_rays (H, W, 3).
    Returns (H, W) uint8."""
    angles = _euler_trajectory(seed, n_modes)(row_times)  # (H, 3)
    R = _euler_to_matrix(angles)  # (H, 3, 3) camera -> world
    world = torch.einsum("hij,hwj->hwi", R, cam_rays)
    return _texture(world, seed).to(torch.uint8)


def make_clip(
    seed: int = 0,
    true_delay: float = 0.0275,
    fps: float = 30.0,
    n_frames: int = 60,
    width: int = 960,
    height: int = 720,
    gyro_rate: float = 200.0,
    readout: float = 0.0085,
    pad: float = 2.0,
    device="cuda",
) -> SyntheticClip:
    """Render the clip on `device` and build its gyro log. The log starts
    pad/2 before frame 0, so the engine's delay against the frame
    timestamps is true_delay + pad/2 (`.true_delay`)."""
    dev = torch.device(device)
    # lens: hero6-like distortion, intrinsics scaled to the render size
    s = width / 2704.0
    lens = lens_ops.Lens(
        ro=readout, fx=1186.0 * s, fy=1186.0 * s,
        cx=width * 0.5012, cy=height * 0.5033,
        k1=0.0444, k2=0.0195, k3=-0.00448, k4=-0.00204,
    )

    # camera rays per pixel (shared across frames)
    vv, uu = torch.meshgrid(
        torch.arange(height, dtype=torch.float64), torch.arange(width, dtype=torch.float64),
        indexing="ij",
    )
    pix = torch.stack([uu, vv], dim=-1).to(_F32).to(dev)
    cam_rays = lens_ops.rays_from_normalized(lens_ops.undistort_points(lens, pix))

    frames = torch.empty((n_frames, height, width), dtype=torch.uint8, device=dev)
    row_frac = np.arange(height) / height
    for f in range(n_frames):
        row_times = torch.as_tensor(f / fps + readout * row_frac, dtype=_F32, device=dev)
        frames[f] = _render_rows(row_times, cam_rays, seed)

    # gyro log on the gyro clock: gyro time tau is render time
    # tau - (true_delay + pad/2); the rates are the discrete +body rates
    # of R(t), the angles evaluated in float32 as rssync_tpu does
    duration = n_frames / fps + pad
    n_g = int(duration * gyro_rate)
    tau = np.arange(n_g) / gyro_rate
    t_video = torch.as_tensor(tau - (true_delay + pad / 2), dtype=_F32)
    ang = _euler_trajectory(seed)(t_video).double().numpy()
    Rm = Rotation.from_euler("ZYX", ang[:, ::-1])  # yaw, pitch, roll
    rel = Rm[:-1].inv() * Rm[1:]
    omega = rel.as_rotvec() * gyro_rate
    omega = np.concatenate([[omega[0]], omega])  # sample 0 pads

    return SyntheticClip(
        frames=frames,
        frame_ts=np.arange(n_frames) / fps,
        gyro_ts=tau,
        gyro_rates=omega,
        lens=lens,
        true_delay=true_delay + pad / 2,
        fps=fps,
        n_frames=n_frames,
        width=width,
        height=height,
        gyro_rate=gyro_rate,
        orient="xyz",
    )


def write_gcsv(path: str, gyro_ts: np.ndarray, gyro_rates: np.ndarray) -> None:
    """Write a gyro log as a GyroFlow .gcsv in rssync_tpu's make_clip
    layout (rssync_tpu/testing/synthvideo.py:187-196): ms timestamps to
    6 decimals (tscale 0.001), rad/s rates to 9 decimals (gscale 1)."""
    with open(path, "w") as f:
        f.write("GYROFLOW IMU LOG\nversion,1.3\nid,synth\n")
        f.write("tscale,0.001\ngscale,1.0\nascale,1.0\nt,gx,gy,gz\n")
        for t, (gx, gy, gz) in zip(gyro_ts, gyro_rates):
            f.write(f"{t * 1000:.6f},{gx:.9f},{gy:.9f},{gz:.9f}\n")


def write_clip_files(clip: SyntheticClip, out_dir: str, block: int = 32) -> ClipFiles:
    """Write `clip` as rssync_tpu's make_clip writes its files
    (rssync_tpu/testing/synthvideo.py:153-210): clip.mp4 (gray frames
    through cv2's mp4v writer at clip.fps; copied from the render device
    `block` frames at a time), clip.gcsv (`write_gcsv`) and lens.txt, one
    `synth_cam` lens-profile row."""
    import os

    import cv2

    os.makedirs(out_dir, exist_ok=True)
    video_path = os.path.join(out_dir, "clip.mp4")
    writer = cv2.VideoWriter(video_path, cv2.VideoWriter_fourcc(*"mp4v"), clip.fps,
                             (clip.width, clip.height), False)
    if not writer.isOpened():
        raise RuntimeError("cv2.VideoWriter failed to open")
    for s in range(0, clip.n_frames, block):
        for img in clip.frames[s : s + block].cpu().numpy():
            writer.write(img)
    writer.release()
    gyro_path = os.path.join(out_dir, "clip.gcsv")
    write_gcsv(gyro_path, clip.gyro_ts, clip.gyro_rates)
    lens, name = clip.lens, "synth_cam"
    lens_path = os.path.join(out_dir, "lens.txt")
    with open(lens_path, "w") as f:
        f.write(f"{name} {lens.ro} {lens.fx} {lens.fy} {lens.cx} {lens.cy} "
                f"{lens.k1} {lens.k2} {lens.k3} {lens.k4}\n")
    return ClipFiles(video_path=video_path, gyro_path=gyro_path, lens_path=lens_path,
                     lens_name=name)
