"""Sync-problem tensors and the epipolar residual rows
(ref: src/core/core_private.hpp:8-22, core_private.cpp:15-32).

A sync window is one padded, fixed-shape set of (frames x features)
tensors, so a whole window, and a stack of windows or delays, is one
batch of tensor ops.

Two layout rules carried over from rssync_tpu:

1. **Timestamp precision**: spline positions are split on the host
   into an int32 base index `i0` (exact) plus an f32 fraction `f0`;
   the device evaluates at `i0 + (f0 + delay * sample_rate)`, so an
   absolute time never lives in f32 (see ops/spline.py).
2. **Structure axis before (frames, features)**: rays are (..., 3, F, N)
   and residual rows P are (..., 3, F, N), so every component is a
   contiguous (F, N) slab.

The spline is evaluated with one coefficient gather per ray
(`coeffs[:, clip(xi, 0, n-1)]`); the 0/1 select it replaces added one
exact coefficient to zeros, so the gather yields the same values.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from rssync_tpu_torch.ops.spline import fit_natural_cubic, horner_eval, pack_table

#: largest rolling-shutter knot span + 4 a frame may have; windows past
#: it are refused (readout_time * gyro_rate <= 12; a GoPro at 200 Hz
#: uses ~2.2), exactly as rssync_tpu refuses them
BAND = 16


@dataclass(frozen=True)
class SplineTable:
    """Fitted gyro-orientation spline on the device.

    coeffs: (16, n_knots) packed per ops/spline.py::pack_table — row
    4c + r is coefficient c (y, b, c, d) of quaternion row r (w,x,y,z).
    sample_rate: () f32 — knots per second.

    A stack of V tables (one per window, or per gyro orientation) has
    coeffs (V, 16, n_knots) and sample_rate (V,); `compute_problem`
    then evaluates each window against its own table.
    """

    coeffs: torch.Tensor
    sample_rate: torch.Tensor

    @property
    def n_knots(self) -> int:
        return self.coeffs.shape[-1]


@dataclass(frozen=True)
class TrackWindow:
    """One sync window (or a stack of them along leading axes).

    rays_a/rays_b: (..., 3, F, N) unit observation rays.
    i0_a/i0_b:     (..., F, N) int32 spline base index at delay = 0.
    f0_a/f0_b:     (..., F, N) f32 fractional spline position at delay 0.
    feat_mask:     (..., F, N) f32 1.0 for valid features else 0.0.
    frame_mask:    (..., F) f32 1.0 for valid frames else 0.0.
    counts:        (..., F) int32 number of valid features per frame.
    """

    rays_a: torch.Tensor
    rays_b: torch.Tensor
    i0_a: torch.Tensor
    i0_b: torch.Tensor
    f0_a: torch.Tensor
    f0_b: torch.Tensor
    feat_mask: torch.Tensor
    frame_mask: torch.Tensor
    counts: torch.Tensor

    @property
    def num_frames(self) -> int:
        return self.i0_a.shape[-2]

    @property
    def num_features(self) -> int:
        return self.i0_a.shape[-1]

    def map(self, fn) -> "TrackWindow":
        """Apply fn to every tensor field."""
        return TrackWindow(**{
            f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)
        })


def table_from_numpy(coeffs: np.ndarray, sample_rate, *, device) -> SplineTable:
    """SplineTable from host arrays: coeffs (16, n) packed, sample_rate
    scalar. Takes rssync_tpu's SplineTable leaves as numpy unchanged."""
    return SplineTable(
        coeffs=torch.tensor(np.asarray(coeffs), dtype=torch.float32, device=device),
        sample_rate=torch.tensor(np.asarray(sample_rate), dtype=torch.float32, device=device),
    )


def window_from_numpy(
    rays_a, rays_b, i0_a, i0_b, f0_a, f0_b, feat_mask, frame_mask, counts,
    *, device,
) -> TrackWindow:
    """TrackWindow from host arrays in rssync_tpu's TrackWindow layout
    (its band origins `base_*` and width `band` are not needed: the
    coefficient gather reads any knot)."""

    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)

    def i32(x):
        return torch.tensor(np.asarray(x), dtype=torch.int32, device=device)

    return TrackWindow(
        rays_a=f32(rays_a), rays_b=f32(rays_b),
        i0_a=i32(i0_a), i0_b=i32(i0_b),
        f0_a=f32(f0_a), f0_b=f32(f0_b),
        feat_mask=f32(feat_mask), frame_mask=f32(frame_mask),
        counts=i32(counts),
    )


def make_spline_table(quats: np.ndarray, sample_rate: float, *, device) -> SplineTable:
    """Fit the orientation spline on the host (f64) and ship packed f32
    coefficients. quats: (n, 4) wxyz samples on a uniform grid
    (ref: ndspline.cpp:13-19)."""
    quats = np.asarray(quats, dtype=np.float64)
    packed = pack_table(fit_natural_cubic(quats.T))  # (16, n)
    return table_from_numpy(packed, np.float32(sample_rate), device=device)


def make_spline_tables_batched(quats: np.ndarray, sample_rate: float, *,
                               device) -> SplineTable:
    """Fit V spline tables at once: quats (V, n, 4) on one uniform grid
    -> a SplineTable with coeffs (V, 16, n) and sample_rate (V,), one
    natural-cubic solve over the 4V rows (guess-orient fits its 48
    orientation variants so)."""
    quats = np.asarray(quats, np.float64)
    V, n, R = quats.shape
    coeffs = fit_natural_cubic(quats.transpose(0, 2, 1).reshape(V * R, n))  # (n, V*R, 4)
    # pack per table: row c*R + r holds coefficient c of spline row r
    packed = np.ascontiguousarray(
        coeffs.reshape(n, V, R, 4).transpose(1, 3, 2, 0).reshape(V, 4 * R, n))
    return table_from_numpy(packed, np.full((V,), sample_rate, np.float32), device=device)


def build_track_window(
    frames_ts_a: Sequence[np.ndarray],
    frames_ts_b: Sequence[np.ndarray],
    frames_rays_a: Sequence[np.ndarray],
    frames_rays_b: Sequence[np.ndarray],
    quats_start: float,
    sample_rate: float,
    *,
    device,
    max_frames: int | None = None,
    max_features: int | None = None,
) -> TrackWindow:
    """Assemble padded window tensors from per-frame ragged track data.

    Host-side numpy, f64 for the timestamp split. The i-th entries of
    the four sequences describe one frame's correspondences: timestamps
    in seconds (rolling-shutter corrected per ray), rays as (n, 3) unit
    vectors.
    """
    F = len(frames_ts_a)
    Fp = max_frames or F
    N = max((len(t) for t in frames_ts_a), default=1)
    Np = max_features or max(N, 1)

    rays_a = np.zeros((3, Fp, Np), dtype=np.float64)
    rays_b = np.zeros((3, Fp, Np), dtype=np.float64)
    i0_a = np.zeros((Fp, Np), dtype=np.int32)
    i0_b = np.zeros((Fp, Np), dtype=np.int32)
    f0_a = np.zeros((Fp, Np), dtype=np.float64)
    f0_b = np.zeros((Fp, Np), dtype=np.float64)
    feat_mask = np.zeros((Fp, Np), dtype=np.float64)
    frame_mask = np.zeros((Fp,), dtype=np.float64)
    counts = np.zeros((Fp,), dtype=np.int32)

    for f in range(F):
        n = len(frames_ts_a[f])
        if n == 0:
            continue
        pos_a = (np.asarray(frames_ts_a[f], np.float64) - quats_start) * sample_rate
        pos_b = (np.asarray(frames_ts_b[f], np.float64) - quats_start) * sample_rate
        ia = np.floor(pos_a).astype(np.int32)
        ib = np.floor(pos_b).astype(np.int32)
        i0_a[f, :n] = ia
        i0_b[f, :n] = ib
        # pad slots carry the frame minimum, as in rssync_tpu
        i0_a[f, n:] = ia.min()
        i0_b[f, n:] = ib.min()
        f0_a[f, :n] = pos_a - ia
        f0_b[f, :n] = pos_b - ib
        for name, span in (("a", ia.max() - ia.min()), ("b", ib.max() - ib.min())):
            if span + 4 > BAND:
                raise ValueError(
                    f"rolling-shutter knot span {span} of frame {f} side "
                    f"{name} exceeds the banded-eval width {BAND}; "
                    "readout_time * gyro_rate is unusually large"
                )
        rays_a[:, f, :n] = np.asarray(frames_rays_a[f], np.float64).T
        rays_b[:, f, :n] = np.asarray(frames_rays_b[f], np.float64).T
        feat_mask[f, :n] = 1.0
        frame_mask[f] = 1.0
        counts[f] = n

    return window_from_numpy(
        rays_a, rays_b, i0_a, i0_b, f0_a, f0_b, feat_mask, frame_mask, counts,
        device=device,
    )


def _conj_rotate_soa(q, v):
    """rotate_point(conj(q), v) by components: q = (w, ux, uy, uz) unit,
    v = (vx, vy, vz), each (...). Returns three (...) tensors.

    v' = v (w^2 - |u|^2) + 2 u (u.v) - 2 w (u x v)
    """
    w, ux, uy, uz = q
    vx, vy, vz = v
    uv = ux * vx + uy * vy + uz * vz
    s = w * w - (ux * ux + uy * uy + uz * uz)
    cx = uy * vz - uz * vy
    cy = uz * vx - ux * vz
    cz = ux * vy - uy * vx
    return (
        vx * s + 2.0 * ux * uv - 2.0 * w * cx,
        vy * s + 2.0 * uy * uv - 2.0 * w * cy,
        vz * s + 2.0 * uz * uv - 2.0 * w * cz,
    )


def cross_soa(a, b):
    """Cross product of component triples a, b -> triple."""
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def dot_soa(a, b) -> torch.Tensor:
    """Dot product of two component sequences, summed left to right."""
    out = a[0] * b[0]
    for x, y in zip(a[1:], b[1:]):
        out = out + x * y
    return out


def _gather_coeffs(table: SplineTable, idx: torch.Tensor) -> torch.Tensor:
    """The packed coefficients at knots idx: (16, *idx.shape). A stack of
    V tables is read at idx's axis -3 (the window axis before frames and
    features), each window from its own table."""
    c = table.coeffs
    if c.dim() == 2:
        return c[:, idx]
    V, R, n = c.shape
    offset = torch.arange(V, device=idx.device).view(V, 1, 1) * n
    return c.permute(1, 0, 2).reshape(R, V * n)[:, idx + offset]


def _spline_quats(table: SplineTable, i0, f0, shift):
    """Unit quaternion components (w, x, y, z) of the spline at
    i0 + f0 + shift; shift broadcasts against i0/f0."""
    n = table.n_knots
    p = f0 + shift
    pf = torch.floor(p)
    xi = i0 + pf.to(torch.int32)
    h_in = p - pf
    idx = torch.clamp(xi, 0, n - 1).long()
    q = horner_eval(_gather_coeffs(table, idx), xi, h_in, n)  # (4, ...)
    q = q * torch.rsqrt(torch.clamp(dot_soa(q, q), min=1e-30))
    return q.unbind(0)


def compute_problem(table: SplineTable, win: TrackWindow, gyro_delay) -> torch.Tensor:
    """Epipolar residual rows for every (frame, feature) at a delay.

    win fields carry leading batch axes Bw (or none); gyro_delay is a
    tensor that broadcasts against Bw (a scalar, (W,) per window, or
    (K, 1) / (K, W) for K delays x W windows). A stacked table (V
    tables) pairs with the axis just before (F, N) of the broadcast
    positions: the W windows, or V for one window. Returns P (*batch, 3, F, N) with
    column (f, i) = cross(ar, br), ar = conj(q(t_a_i + delay)) rotating
    ray_a_i and likewise br: the pure-translation epipolar rows with
    P^T M ~= 0 at the correct delay (ref: core_private.cpp:15-32).
    Padded entries are zero.
    """
    shift = (gyro_delay * table.sample_rate)[..., None, None]
    q_a = _spline_quats(table, win.i0_a, win.f0_a, shift)
    q_b = _spline_quats(table, win.i0_b, win.f0_b, shift)
    ar = _conj_rotate_soa(q_a, win.rays_a.unbind(-3))
    br = _conj_rotate_soa(q_b, win.rays_b.unbind(-3))
    return torch.stack(cross_soa(ar, br), dim=-3) * win.feat_mask[..., None, :, :]
