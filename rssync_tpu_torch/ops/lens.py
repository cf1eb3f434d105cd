"""Fisheye (Kannala-Brandt / OpenCV-fisheye) lens model, batched.

The reference undistorts one pixel at a time with 9 Newton iterations
and a bisection safeguard (ref: src/core_testcode.cpp:56-95). Here the
whole point set is one tensor computation, and the safeguard's
data-dependent `while` is a fixed-count halving loop: each halving
moves the iterate geometrically toward the previous in-range theta, so
40 steps are more than any double-precision case can need.

Every function computes in the dtype of the points it is given, on
their device. The lens coefficients are rounded to that dtype first,
so float32 points see float32 coefficients, as in rssync_tpu.

`lift_points` is emission's undistort and ray lift in one call: on CPU
tensors it computes the plain version `lift_points_ref`
(`rays_from_normalized(undistort_points(...))`); on CUDA tensors it
launches the kernel of csrc/lift_rays.cu, one thread a point, or raises.
The two are bit-equal on the card.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from rssync_tpu_torch.utils.timing import count

#: kernel launches, counted where the wrapper launches its kernel
LAUNCHES = {"lift_points": 0}
#: the (points' shape..., dtype) the kernel was launched at
LAUNCH_SHAPES = {"lift_points": set()}


def reset_launch_counters() -> None:
    """Zero LAUNCHES and empty LAUNCH_SHAPES."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        LAUNCH_SHAPES[name].clear()


@dataclass(frozen=True)
class Lens:
    """Lens parameters (ref: src/core_testcode.cpp:56-61).

    ro: rolling-shutter readout time in seconds (full frame).
    fx, fy, cx, cy: pinhole intrinsics in pixels.
    k1..k4: Kannala-Brandt theta-polynomial distortion coefficients.
    """

    ro: float = 0.0
    fx: float = 1.0
    fy: float = 1.0
    cx: float = 0.0
    cy: float = 0.0
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0

    def as_array(self) -> np.ndarray:
        return np.array(
            [self.ro, self.fx, self.fy, self.cx, self.cy,
             self.k1, self.k2, self.k3, self.k4],
            dtype=np.float64,
        )

    @classmethod
    def from_array(cls, a) -> "Lens":
        """The inverse of `as_array`."""
        return cls(*(float(x) for x in np.asarray(a, np.float64).reshape(9)))


def _coef(k: float, dtype: torch.dtype) -> float:
    """k rounded to `dtype` (a Python float holding that value)."""
    return float(torch.tensor(k, dtype=torch.float64).to(dtype))


def distort_theta(theta, k1, k2, k3, k4):
    """Forward distortion polynomial theta_d(theta) =
    theta + k1 th^3 + k2 th^5 + k3 th^7 + k4 th^9."""
    t2 = theta * theta
    return theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))


def undistort_points(lens: Lens, points: torch.Tensor,
                     num_iterations: int = 9) -> torch.Tensor:
    """Invert the fisheye model: pixel coordinates (..., 2) ->
    normalized image-plane coordinates (x/z, y/z) (..., 2).

    Normalize by the intrinsics, run 9 Newton iterations on theta from
    pi/4 with the safeguard keeping theta in (0, pi/2), then scale by
    tan(theta)/theta_d (ref: core_testcode.cpp:63-95). Two details as
    in the reference and rssync_tpu:

    * the early-out `|point| < 1e-8 -> (0, 0)` tests the RAW pixel
      coordinates (it only fires at the image corner);
    * the Newton derivative uses the true `9*k4*theta^8` where the
      reference has 8; the residual defines the root, so both converge
      to it.
    """
    pts = torch.as_tensor(points)
    dtype = pts.dtype
    x_ = (pts[..., 0] - lens.cx) / lens.fx
    y_ = (pts[..., 1] - lens.cy) / lens.fy
    theta_d = torch.sqrt(x_ * x_ + y_ * y_)

    k1, k2, k3, k4 = (_coef(k, dtype) for k in (lens.k1, lens.k2, lens.k3, lens.k4))
    # the derivative's coefficients, each product rounded once in dtype
    d3, d5, d7, d9 = (_coef(c * k, dtype) for c, k in ((3.0, k1), (5.0, k2), (7.0, k3), (9.0, k4)))

    half_pi = _coef(np.pi / 2.0, dtype)
    theta = torch.full_like(theta_d, np.pi / 4.0)
    for _ in range(num_iterations):
        t2 = theta * theta
        t4 = t2 * t2
        t6 = t4 * t2
        t8 = t4 * t4
        cur = distort_theta(theta, k1, k2, k3, k4)
        dcur = 1.0 + d3 * t2 + d5 * t4 + d7 * t6 + d9 * t8
        new_theta = theta - (cur - theta_d) / dcur
        # safeguard: halve back toward the (in-range) previous iterate
        # while outside (0, pi/2); a fixed unroll of the data-dependent
        # while at core_testcode.cpp:85-87
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


def distort_points(lens: Lens, xy: torch.Tensor) -> torch.Tensor:
    """Forward model: normalized image plane (x/z, y/z) -> pixels. Used
    by the tests and the synthetic renderers; the reference only
    inverts."""
    xy = torch.as_tensor(xy)
    r = torch.sqrt(torch.sum(xy * xy, dim=-1))
    theta = torch.atan(r)
    td = distort_theta(theta, lens.k1, lens.k2, lens.k3, lens.k4)
    scale = torch.where(r < 1e-12, torch.ones_like(r), td / torch.clamp(r, min=1e-30))
    u = xy[..., 0] * scale * lens.fx + lens.cx
    v = xy[..., 1] * scale * lens.fy + lens.cy
    return torch.stack([u, v], dim=-1)


def rays_from_normalized(xy: torch.Tensor) -> torch.Tensor:
    """Lift normalized image-plane points to unit rays
    normalize([x, y, 1]) (ref: core_testcode.cpp:147-152)."""
    v = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def lift_points_ref(lens: Lens, points: torch.Tensor) -> torch.Tensor:
    """Plain version of `lift_points`."""
    return rays_from_normalized(undistort_points(lens, points))


def kernel_constants(lens: Lens, dtype: torch.dtype) -> list[float]:
    """The lens constants of csrc/lift_rays.cu (LensConsts' order), each
    as `undistort_points` meets it on the card: a Python number rounded to
    `dtype`, the derivative's products rounded once, and the division by
    fx (fy) as a product with its reciprocal rounded in `dtype` (PyTorch on
    CUDA divides by a Python scalar so)."""
    def inv(v):
        one = torch.tensor(1.0, dtype=dtype)
        return float(one / torch.tensor(_coef(v, dtype), dtype=dtype))

    k = [_coef(v, dtype) for v in (lens.k1, lens.k2, lens.k3, lens.k4)]
    d = [_coef(m * v, dtype) for m, v in zip((3.0, 5.0, 7.0, 9.0), k)]
    return [_coef(lens.cx, dtype), _coef(lens.cy, dtype), inv(lens.fx), inv(lens.fy), *k, *d,
            _coef(np.pi / 2.0, dtype), _coef(np.pi / 4.0, dtype)]


@functools.lru_cache(maxsize=16)
def _launch_constants(lens: Lens, dtype: torch.dtype):
    """`kernel_constants` as the launch takes them, made once a lens."""
    return (ctypes.c_double * 14)(*kernel_constants(lens, dtype))


def _launch(lens: Lens, points: torch.Tensor) -> torch.Tensor:
    from rssync_tpu_torch.ops import _kernels

    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"lift_points: unsupported device {dev}")
    rays = torch.empty((*points.shape[:-1], 3), dtype=points.dtype, device=dev)
    n = points.numel() // 2
    if n == 0:
        return rays
    lib = _kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lift_rays_launch(points.data_ptr(), rays.data_ptr(), n,
                                  int(points.dtype == torch.float64),
                                  _launch_constants(lens, points.dtype), stream)
    if rc != 0:
        raise RuntimeError(f"lift_points launch failed: {lib.lift_rays_error_string(rc).decode()}")
    LAUNCHES["lift_points"] += 1
    LAUNCH_SHAPES["lift_points"].add((*points.shape, str(points.dtype)))
    count("lift_launches")
    return rays


def lift_points(lens: Lens, points: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> unit rays (..., 3): `rays_from_normalized(
    undistort_points(lens, points))` in one call, in the points' dtype
    (float32 or float64) on their device. The points must be contiguous."""
    if points.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"lift_points: points must be float32 or float64, got {points.dtype}")
    if points.dim() == 0 or points.shape[-1] != 2:
        raise ValueError(f"lift_points: points must be (..., 2), got {tuple(points.shape)}")
    if not points.is_contiguous():
        raise ValueError("lift_points: points must be contiguous")
    if points.device.type == "cpu":
        return lift_points_ref(lens, points)
    return _launch(lens, points)
