"""The plain reference of the room scene (`portbench/gen/room.py`): what a
perfect tracker and a perfect sync return on a clip whose camera
rotates and translates inside a textured box.

Model. The camera's centre is C(t), a sum of sinusoids an axis about
the box's origin; its orientation is M R(t): synthclip's Euler-angle
rotation R(t), after a constant mount pitch M about the camera's x axis
(the world's y axis points down, z at the wall the camera faces). Each
row is exposed at its rolling-shutter time. The box is convex and the
camera inside it, so every ray leaves it through exactly one wall and
nothing is occluded:

- a grid point p of frame a, t_a = a / fps + readout * p_y / height,
  shows the world point X = C(t_a) + s M R(t_a) ray(p), where s is the
  distance at which the ray leaves the box;
- in frame b = a + 1 it appears at q = distort(R(t_b)^T M^T (X - C(t_b))),
  t_b = b / fps + readout * q_y / height, which truth.py's fixed-point
  iteration on q_y finds;
- the delays, the grid, the lens inversion and the pixels of the
  program's rays are truth.py's own (the gyro senses no translation).

Departures from the thesis's "table" clip (thesis-text.pdf p.34): a
synthetic box with a solid procedural texture, not a table of objects;
no occlusion; no change of lighting; no motion blur; and sizes (the
box, the pitch, the translation's amplitudes and band) that the
configuration assumes, since the thesis gives none of that clip's.

Everything is plain elementwise torch in one dtype (float64 for the
reference, bfloat16 for the control) with no matrix product. It imports
nothing of the program under test and takes nothing the program made:
the trajectory is the generator's draw from the seed and the
configuration's `scene` section.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.truth import (  # noqa: F401  (this scene's delays, grid and lens)
    RS_STEPS,
    _angles,
    _rotate,
    distort_ray,
    grid_points,
    tracked_pixels,
    undistort_ray,
    window_delays,
)


def _pitch(traj, v: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """M v (or M^T v): the mount pitch, a rotation about x that turns
    the optical axis +z down (+y) by `pitch_rad`."""
    c = torch.tensor(np.cos(traj["pitch_rad"]), dtype=v.dtype)
    s = torch.tensor(np.sin(traj["pitch_rad"]), dtype=v.dtype)
    if inverse:
        s = -s
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([x, c * y + s * z, c * z - s * y], -1)


def centre(traj, t: torch.Tensor) -> torch.Tensor:
    """(..., 3) the camera's centre C(t), m, in t's dtype."""
    return _angles(traj["translation"], t)


def orientation(traj, t: torch.Tensor, v: torch.Tensor, inverse: bool = False):
    """M R(t) v (or R(t)^T M^T v) for camera vectors v (..., 3)."""
    ang = _angles(traj["rotation"], t)
    if inverse:
        return _rotate(ang, _pitch(traj, v, inverse=True), inverse=True)
    return _pitch(traj, _rotate(ang, v))


def exit_distance(traj, c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(...,) the distance s > 0 at which the ray c + s d, from a point c
    inside the box, leaves it: the nearest wall ahead on each axis."""
    one = torch.ones_like(d[..., 0])
    best = None
    for i, (lo, hi) in enumerate(traj["box_m"]):
        di = d[..., i]
        wall = torch.where(di > 0, torch.tensor(hi, dtype=d.dtype), torch.tensor(lo, dtype=d.dtype))
        ahead = di != 0
        s = torch.where(ahead, (wall - c[..., i]) / torch.where(ahead, di, one),
                        torch.full_like(di, float("inf")))
        best = s if best is None else torch.minimum(best, s)
    return best


def world_points(traj, lens: dict, pts: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3) the world point that pixel pts (..., 2) shows at times t
    (...,): where its ray leaves the box."""
    c = centre(traj, t)
    d = orientation(traj, t, undistort_ray(lens, pts).expand(*t.shape, 3))
    return c + exit_distance(traj, c, d)[..., None] * d


def true_tracks(traj, lens: dict, grid: np.ndarray, frames_a: np.ndarray, fps: float,
                height: int, dtype=torch.float64) -> torch.Tensor:
    """(P, N, 2) true positions in frame a + 1 of the N grid points of
    each frame a in `frames_a` (P,), computed in `dtype` on the CPU."""
    ro = torch.tensor(lens["ro"], dtype=dtype)
    g = torch.as_tensor(grid, dtype=dtype)  # (N, 2)
    fa = torch.as_tensor(np.asarray(frames_a, np.float64), dtype=dtype)[:, None]  # (P, 1)
    inv_fps = torch.tensor(1.0 / fps, dtype=dtype)
    t_a = fa * inv_fps + ro * g[None, :, 1] / height  # (P, N)
    X = world_points(traj, lens, g[None], t_a)
    q_y = g[None, :, 1].expand_as(t_a)
    for _ in range(RS_STEPS):
        t_b = (fa + 1) * inv_fps + ro * q_y / height
        q = distort_ray(lens, orientation(traj, t_b, X - centre(traj, t_b), inverse=True))
        q_y = q[..., 1]
    return q
