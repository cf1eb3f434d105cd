"""Gyro angular-rate integration into orientation quaternions.

Rebuild of the reference's sequential integration loop
(ref: src/core_testcode.cpp:37-54): the reference folds
q_i = normalize(quat_from_aa(omega_i * dt_i) * q_{i-1}) one sample at a
time, in double precision.

This is host-side ingest, so it runs in f64 numpy: a 100k-sample log
integrates in milliseconds, and f32 accumulation over a 400 s log
drifts the global orientation (the reference is f64 here,
core_testcode.cpp:41-46, so the port is too). A copy of
rssync_tpu/frontend/integrate.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import numpy as np


def _quat_from_aa64(aa: np.ndarray) -> np.ndarray:
    """Axis-angle -> unit quaternion, f64, Ceres-style small-angle
    guard (ref quat.cpp:5-17)."""
    theta2 = np.sum(aa * aa, axis=-1, keepdims=True)
    theta = np.sqrt(np.maximum(theta2, 1e-300))
    half = 0.5 * theta
    k = np.where(theta2 > 0.0, np.sin(half) / theta, 0.5)
    w = np.where(theta2 > 0.0, np.cos(half), 1.0)
    return np.concatenate([w, aa * k], axis=-1)


def _quat_mul64(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack(
        [
            pw * qw - px * qx - py * qy - pz * qz,
            pw * qx + px * qw + py * qz - pz * qy,
            pw * qy - px * qz + py * qw + pz * qx,
            pw * qz + px * qy - py * qx + pz * qw,
        ],
        axis=-1,
    )


def integrate_gyro(
    timestamps: np.ndarray, gyro: np.ndarray, dtype=None
) -> np.ndarray:
    """Integrate angular rates into orientations, f64 on host.

    timestamps: (n,) seconds. gyro: (..., n, 3) rad/s (body rates;
    leading axes batch — guess-orient integrates its 48 orientation
    variants in one call). Returns (..., n, 4) f64 wxyz quaternions
    with q_0 = identity and q_i = normalize(dq_i * q_{i-1}), dq_i =
    exp(omega_i * (t_i - t_{i-1})) — the left-multiply convention of
    ref core_testcode.cpp:41-46. `dtype` is accepted for API
    compatibility and ignored (output is always f64, like the
    reference).
    """
    del dtype
    ts = np.asarray(timestamps, np.float64)
    g = np.asarray(gyro, np.float64)
    n = ts.shape[0]
    if n == 0:
        return np.zeros(g.shape[:-2] + (0, 4))
    dt = np.diff(ts)
    dq = _quat_from_aa64(g[..., 1:, :] * dt[:, None])  # (..., n-1, 4)

    # Quaternion composition is associative, so the left-multiply fold
    # becomes a Hillis-Steele doubling scan: prefix[i] = dq_i * ... *
    # dq_1 in O(log n) vectorized passes.  The reference normalizes
    # after every sequential step; normalizing once per doubling level
    # differs only at f64 rounding (~1e-16/op).
    m = dq.copy()
    shift = 1
    while shift < m.shape[-2]:
        m[..., shift:, :] = _quat_mul64(m[..., shift:, :], m[..., :-shift, :])
        m /= np.maximum(
            np.linalg.norm(m, axis=-1, keepdims=True), 1e-300
        )
        shift *= 2

    out = np.empty(g.shape[:-2] + (n, 4))
    out[..., 0, :] = (1.0, 0.0, 0.0, 0.0)
    out[..., 1:, :] = m
    return out


def integrate_gyro_fixed_rate(gyro: np.ndarray, sample_rate: float) -> np.ndarray:
    """Fixed-rate variant (ref: core_testcode.cpp:20-35, the `#if 0`
    path): dt = 1/sample_rate for every step."""
    n = np.asarray(gyro).shape[0]
    ts = np.arange(n, dtype=np.float64) / float(sample_rate)
    return integrate_gyro(ts, gyro)
