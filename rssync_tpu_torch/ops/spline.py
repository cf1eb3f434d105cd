"""Uniform-grid natural cubic splines, split host-fit / device-eval
(ref: src/core_support/minispline.cpp:3-64, ndspline.cpp:13-27).

Fitting happens once per gyro intake and stays on the host in float64
(numpy Thomas solve over all rows at once). Evaluation runs on the
device as one coefficient gather per position plus Horner.

Precision scheme: float32 cannot hold `(ts - quats_start + delay) *
sample_rate` (ref: src/core/core_private.cpp:18-19) at sub-microsecond
resolution for long clips, so every evaluation position is split into
an int32 knot index `i0` (computed on the host in f64) plus a small f32
residual `p`; the device only adds small f32 numbers.

Boundary semantics replicate the reference (minispline.cpp:48-55):
inside [0, n-1] the cubic; below 0 a quadratic continuation of segment
0; above n-1 a quadratic continuation of segment n-1. For x >= n the
reference measures h from knot n while keeping segment n-1's
coefficients, a jump at x = n; that quirk is replicated.
"""

from __future__ import annotations

import numpy as np
import torch

from rssync_tpu_torch.ops import quat as quat_ops


def fit_natural_cubic(y: np.ndarray) -> np.ndarray:
    """Fit natural cubic splines to uniformly-indexed samples.

    y: (R, n) float64 — R independent rows sampled at x = 0..n-1.
    Returns coeffs (n, R, 4) float64 ordered (y, b, c, d) so that on
    segment i (x = i + h, 0 <= h < 1):

        f(x) = ((d_i * h + c_i) * h + b_i) * h + y_i

    Matches the linear system of ref minispline.cpp:3-46: natural
    boundary (c_0 = c_{n-1} = 0), interior rows
    (1/3) c_{i-1} + (4/3) c_i + (1/3) c_{i+1} = y_{i+1} - 2 y_i + y_{i-1},
    then d_i = (c_{i+1} - c_i)/3,
    b_i = (y_{i+1} - y_i) - (2 c_i + c_{i+1})/3 for i < n-1, and the
    end-segment continuation d_{n-1} = 0,
    b_{n-1} = 3 d_{n-2} + 2 c_{n-2} + b_{n-2}.
    """
    y = np.asarray(y, dtype=np.float64)
    if y.ndim == 1:
        y = y[None, :]
    R, n = y.shape
    if n < 3:
        # Degenerate: fall back to linear interpolation coefficients.
        c = np.zeros_like(y)
        d = np.zeros_like(y)
        b = np.zeros_like(y)
        if n == 2:
            b[:, 0] = y[:, 1] - y[:, 0]
            b[:, 1] = y[:, 1] - y[:, 0]
        return np.stack([y, b, c, d], axis=-1).transpose(1, 0, 2)

    # Thomas solve of the tridiagonal system, vectorized over rows.
    # Diagonals: lower = upper = 1/3 on interior rows, main = 4/3
    # interior and 2 at the ends (with 0 off-diagonals there).
    lo = np.full(n, 1.0 / 3.0)
    mid = np.full(n, 4.0 / 3.0)
    up = np.full(n, 1.0 / 3.0)
    lo[0] = lo[-1] = 0.0
    up[0] = up[-1] = 0.0
    mid[0] = mid[-1] = 2.0
    rhs = np.zeros((R, n))
    rhs[:, 1:-1] = y[:, 2:] - 2.0 * y[:, 1:-1] + y[:, :-2]

    cp = np.zeros(n)
    dp = np.zeros((R, n))
    cp[0] = up[0] / mid[0]
    dp[:, 0] = rhs[:, 0] / mid[0]
    for i in range(1, n):
        denom = mid[i] - lo[i] * cp[i - 1]
        cp[i] = up[i] / denom
        dp[:, i] = (rhs[:, i] - lo[i] * dp[:, i - 1]) / denom
    c = np.zeros((R, n))
    c[:, -1] = dp[:, -1]
    for i in range(n - 2, -1, -1):
        c[:, i] = dp[:, i] - cp[i] * c[:, i + 1]

    d = np.zeros((R, n))
    b = np.zeros((R, n))
    d[:, :-1] = (c[:, 1:] - c[:, :-1]) / 3.0
    b[:, :-1] = (y[:, 1:] - y[:, :-1]) - (2.0 * c[:, :-1] + c[:, 1:]) / 3.0
    d[:, -1] = 0.0
    b[:, -1] = 3.0 * d[:, -2] + 2.0 * c[:, -2] + b[:, -2]

    return np.stack([y, b, c, d], axis=-1).transpose(1, 0, 2)  # (n, R, 4)


def pack_table(coeffs: np.ndarray) -> np.ndarray:
    """Repack host-fit coefficients (n, R, 4) into the device layout
    (4*R, n): row R*c + r holds coefficient c (0=y,1=b,2=c,3=d) of
    spline row r, knots along the last axis, so one gather along that
    axis yields every coefficient with the batch shape trailing."""
    n, R, _ = coeffs.shape
    return np.ascontiguousarray(coeffs.transpose(2, 1, 0).reshape(4 * R, n))


def horner_eval(
    g: torch.Tensor, xi: torch.Tensor, h_in: torch.Tensor, n: int
) -> torch.Tensor:
    """Spline value from gathered coefficients.

    g: (4R, ...) coefficients of knot clip(xi, 0, n-1), packed as in
    pack_table. xi: (...) int32 floor of the position; h_in: (...) its
    fractional part. Returns (R, ...) with the boundary branches of
    the module docstring.
    """
    R = g.shape[0] // 4
    yk, bk, ck, dk = g[:R], g[R:2 * R], g[2 * R:3 * R], g[3 * R:]
    below = xi < 0
    above = xi > n - 2
    h_lo = xi.to(h_in.dtype) + h_in
    # ref quirk: idx = min(floor(x), n), so h measures from knot n (one
    # past the end) once x >= n — discontinuous at x == n
    # (minispline.cpp:49-53); replicated
    h_hi = (xi - (n - 1) - (xi >= n).to(xi.dtype)).to(h_in.dtype) + h_in
    h = torch.where(below, h_lo, torch.where(above, h_hi, h_in))[None]
    cubic = ((dk * h + ck) * h + bk) * h + yk
    quad = (ck * h + bk) * h + yk
    return torch.where((below | above)[None], quad, cubic)


def eval_spline_packed(
    packed: torch.Tensor, i0: torch.Tensor, p: torch.Tensor
) -> torch.Tensor:
    """Evaluate R splines at x = i0 + p from the packed (4R, n) table.

    i0: (...) int32 knot index; p: (...) small f32 offset — x itself is
    never formed, only floor(p) is folded into the index. Returns
    (R, ...), row axis leading.
    """
    n = packed.shape[1]
    pf = torch.floor(p)
    xi = i0 + pf.to(torch.int32)
    h_in = p - pf
    idx = torch.clamp(xi, 0, n - 1)
    return horner_eval(packed[:, idx.long()], xi, h_in, n)


def _unpacked_position(coeffs: torch.Tensor, i0: torch.Tensor, p: torch.Tensor):
    """(gathered coefficients (..., R, 4), xi, h (..., 1), below | above)
    of x = i0 + p against an unpacked (n, R, 4) table: floor(p) folded
    into the index, h measured as in horner_eval's branches."""
    n = coeffs.shape[0]
    pf = torch.floor(p)
    xi = i0 + pf.to(torch.int32)
    h_in = p - pf
    cf = coeffs[torch.clamp(xi, 0, n - 1).long()]  # (..., R, 4)
    below = xi < 0
    above = xi > n - 2
    h_lo = xi.to(h_in.dtype) + h_in
    h_hi = (xi - (n - 1) - (xi >= n).to(xi.dtype)).to(h_in.dtype) + h_in
    h = torch.where(below, h_lo, torch.where(above, h_hi, h_in))[..., None]
    return cf, h, (below | above)[..., None]


def eval_spline(coeffs: torch.Tensor, i0: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Evaluate R splines at x = i0 + p from unpacked coefficients.

    coeffs: (n, R, 4) (y, b, c, d) per knot per row, as
    fit_natural_cubic returns them; i0: (...) int32; p: (...) small
    float offset. Returns (..., R), row axis trailing (the packed form
    is eval_spline_packed). ref: ndspline.cpp:21-27 with the boundary
    branches of the module docstring."""
    cf, h, outside = _unpacked_position(coeffs, i0, p)
    yk, bk, ck, dk = cf.unbind(-1)
    cubic = ((dk * h + ck) * h + bk) * h + yk
    quad = (ck * h + bk) * h + yk
    return torch.where(outside, quad, cubic)


def eval_spline_deriv(coeffs: torch.Tensor, i0: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """d/dx of eval_spline (ref: minispline.cpp:57-64, ndspline.cpp:29-35)."""
    cf, h, outside = _unpacked_position(coeffs, i0, p)
    _, bk, ck, dk = cf.unbind(-1)
    cubic = (3.0 * dk * h + 2.0 * ck) * h + bk
    quad = 2.0 * ck * h + bk
    return torch.where(outside, quad, cubic)


def rotational_deriv(coeffs: torch.Tensor, i0: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Angular-velocity quaternion of a quaternion spline:
    2 * conj(q) * q' / |q|^2 (ref: ndspline::rderiv, ndspline.cpp:45-49).
    coeffs holds exactly 4 rows (w, x, y, z). Returns (..., 4) whose
    vector part is the body rate in spline-index units."""
    q = eval_spline(coeffs, i0, p)
    dq = eval_spline_deriv(coeffs, i0, p)
    n2 = torch.clamp(torch.sum(q * q, dim=-1, keepdim=True), min=1e-30)
    return 2.0 * quat_ops.mul(quat_ops.conj(q), dq) / n2


def rotational_deriv_numeric(coeffs: torch.Tensor, i0: torch.Tensor, p: torch.Tensor,
                             eps: float = 1e-7) -> torch.Tensor:
    """Numeric-difference variant (ref: ndspline::rderiv_numeric,
    ndspline.cpp:37-43): conj(normalize(q(t))) * normalize(q(t + eps)) /
    eps with the scalar part zeroed. The reference formula lacks the
    factor 2 of `rotational_deriv`, so this is half the body rate,
    replicated as it is."""
    q_l = quat_ops.normalize(eval_spline(coeffs, i0, p))
    q_r = quat_ops.normalize(eval_spline(coeffs, i0, p + eps))
    out = quat_ops.mul(quat_ops.conj(q_l), q_r) / eps
    return torch.cat([torch.zeros_like(out[..., :1]), out[..., 1:]], dim=-1)
