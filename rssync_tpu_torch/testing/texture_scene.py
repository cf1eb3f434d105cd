"""Affine-warped textured frame sequences with analytic ground-truth
flow: the real-pixel tracking accuracy harness.

Each frame samples one big smooth texture at affine-transformed
coordinates (rotation about the frame center + a translation random
walk mixing small and large steps), so the true flow of any image
point between consecutive frames is known in closed form.

A copy of rssync_tpu/testing/texture_scene.py (the same numpy draws,
so one seed gives the same frames); the port imports nothing of the
JAX package. One deliberate deviation: where the background's padding
is odd at a frame size that is a multiple of 4, rssync_tpu's copy
raises and this one edge-pads the fine octave to size. Rendering is
host-side (scipy affine_transform) and takes seconds a frame at
2704x2028; a sequence may be cached in `cache_dir`, which is off by
default.
"""

from __future__ import annotations

import os

import numpy as np


def render_scene(
    seed: int,
    n_frames: int,
    height: int,
    width: int,
    max_step: float = 60.0,
    rot: float = 0.004,
    cache_dir: str | None = None,
):
    """Returns (frames (T, H, W) u8, affines [(R (2,2), off (2,))]).

    Affine convention (scipy): texture_yx = R @ out_yx + off for each
    output pixel of frame i.
    """
    key = f"tex2_{seed}_{n_frames}_{height}x{width}_{max_step}_{rot}"
    if cache_dir:
        path = os.path.join(cache_dir, key + ".npz")
        if os.path.exists(path):
            z = np.load(path)
            R = z["R"]
            off = z["off"]
            return z["frames"], [(R[i], off[i]) for i in range(len(R))]

    from scipy import ndimage

    rng = np.random.default_rng(seed)
    pad = int(max_step * n_frames ** 0.5) + 400
    Hb, Wb = height + 2 * pad, width + 2 * pad
    # multi-octave texture: real video has structure at every pyramid
    # scale; single-octave blurred noise is featureless at the coarse
    # levels the SAD init runs on (measured: ~9% of points lost on
    # large-motion frames against such a scene)
    fine = rng.normal(size=(Hb // 4, Wb // 4)).astype(np.float32)
    fine = ndimage.zoom(fine, 4.0, order=3)[:Hb, :Wb]
    # the zoom has 4 (Hb // 4) rows and 4 (Wb // 4) columns: short of
    # (Hb, Wb) unless both are multiples of 4 (an odd pad at frame sizes
    # that are), where rssync_tpu's copy raises; edge rows fill the gap
    fine = np.pad(fine, ((0, Hb - fine.shape[0]), (0, Wb - fine.shape[1])), mode="edge")
    tex = ndimage.gaussian_filter(fine, 1.2)
    for sigma in (8.0, 32.0, 128.0):
        oct_ = rng.normal(size=(Hb, Wb)).astype(np.float32)
        oct_ = ndimage.gaussian_filter(oct_, sigma)
        tex = tex + oct_ * (sigma / 2.0)  # equalize per-octave power
    tex = (tex - tex.min()) / (tex.max() - tex.min() + 1e-9) * 255.0

    frames = np.empty((n_frames, height, width), np.uint8)
    affines = []
    cx, cy = width / 2, height / 2
    t = np.array([pad + 10.0, pad + 10.0])
    ang = 0.0
    for i in range(n_frames):
        step = rng.normal() * (3.0 if i % 7 else max_step)
        dxy = rng.normal(size=2)
        dxy = dxy / (np.linalg.norm(dxy) + 1e-9) * abs(step)
        t = t + dxy
        ang = ang + rng.normal() * rot
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, -s], [s, c]])
        off = np.array([cy, cx]) - R @ np.array([cy, cx]) + t[::-1]
        frames[i] = np.clip(
            ndimage.affine_transform(
                tex, R, offset=off, order=1, output_shape=(height, width)
            ),
            0, 255,
        ).astype(np.uint8)
        affines.append((R.copy(), off.copy()))

    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(
            path,
            frames=frames,
            R=np.stack([a[0] for a in affines]),
            off=np.stack([a[1] for a in affines]),
        )
    return frames, affines


def true_flow(affines, pts_xy: np.ndarray) -> np.ndarray:
    """(T-1, N, 2) ground-truth flow of `pts_xy` between consecutive
    frames: the point x' in frame i+1 seeing the same texture as x in
    frame i satisfies A_{i+1}(x') = A_i(x)."""
    flows = []
    for (R0, o0), (R1, o1) in zip(affines[:-1], affines[1:]):
        yx = pts_xy[:, ::-1]
        tex_yx = yx @ R0.T + o0
        yx1 = (tex_yx - o1) @ np.linalg.inv(R1).T
        flows.append((yx1 - yx)[:, ::-1])
    return np.stack(flows)


def tracking_error(
    tracked: np.ndarray, pts_xy: np.ndarray, affines,
    width: int, height: int, border: int = 30,
):
    """(median, p95) px error of tracked positions vs analytic flow,
    over points whose true end position stays `border` px inside the
    frame."""
    gt = true_flow(affines, pts_xy.astype(np.float64))
    flow = tracked - pts_xy[None]
    err = np.linalg.norm(flow - gt, axis=-1)
    end = pts_xy[None] + gt
    ok = (
        (end[..., 0] > border) & (end[..., 0] < width - border)
        & (end[..., 1] > border) & (end[..., 1] < height - border)
    )
    e = err[ok]
    return float(np.median(e)), float(np.quantile(e, 0.95))
