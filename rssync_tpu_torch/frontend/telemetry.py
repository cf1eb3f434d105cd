"""Gyro axis conventions.

Orientation strings: 3 chars from {x,X,y,Y,z,Z}; output axis i takes
the named source component, negated for a lowercase letter:
out[:, i] = sign(c_i) * src[:, axis(c_i)], sign = +1 for uppercase.
The reference warns its convention is not GyroFlow's (README.md:47).

Only `apply_orientation` is ported so far; the telemetry parsers of
rssync_tpu/frontend/telemetry.py are still to port (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np

_ORIENT_AXES = {"x": 0, "y": 1, "z": 2}


def apply_orientation(gyro: np.ndarray, orient: str | None) -> np.ndarray:
    """Axis remap/sign flip of (n, 3) rates per the orientation string."""
    if not orient:
        return gyro
    if len(orient) != 3 or any(c.lower() not in _ORIENT_AXES for c in orient):
        raise ValueError(f"bad orientation string {orient!r}")
    out = np.empty_like(gyro)
    for i, c in enumerate(orient):
        sign = 1.0 if c.isupper() else -1.0
        out[:, i] = sign * gyro[:, _ORIENT_AXES[c.lower()]]
    return out
