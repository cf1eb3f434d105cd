"""Batched quaternion algebra (ref: src/core_support/quat.cpp:5-101).

Quaternions are tensors of shape (..., 4) in (w, x, y, z) order;
3-vectors are (..., 3). Every function broadcasts over leading axes and
is differentiable: the small-angle branches of the reference become
`torch.where` selections with guarded denominators.
"""

from __future__ import annotations

import torch

_EPS = 1e-30


def from_axis_angle(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (rotation vector) -> unit quaternion, with the
    Ceres-style small-angle guard of ref quat.cpp:5-17."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    half = 0.5 * theta
    nonzero = theta2 > 0.0
    k = torch.where(nonzero, torch.sin(half) / theta, 0.5)
    w = torch.where(nonzero, torch.cos(half), torch.ones_like(theta))
    return torch.cat([w, aa * k], dim=-1)


def to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> axis-angle (ref: quat.cpp:19-31)."""
    w = q[..., :1]
    xyz = q[..., 1:]
    sin2 = torch.sum(xyz * xyz, dim=-1, keepdim=True)
    sin_t = torch.sqrt(torch.clamp(sin2, min=_EPS))
    # atan2 branch: take the representation with |angle| <= pi
    two_theta = 2.0 * torch.where(
        w < 0.0, torch.atan2(-sin_t, -w), torch.atan2(sin_t, w)
    )
    k = torch.where(sin2 > 0.0, two_theta / sin_t, 2.0)
    return xyz * k


def mul(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Hamilton product p*q (ref: quat.cpp:33-38)."""
    pw, px, py, pz = p.unbind(-1)
    qw, qx, qy, qz = q.unbind(-1)
    return torch.stack(
        [
            pw * qw - px * qx - py * qy - pz * qz,
            pw * qx + px * qw + py * qz - pz * qy,
            pw * qy - px * qz + py * qw + pz * qx,
            pw * qz + px * qy - py * qx + pz * qw,
        ],
        dim=-1,
    )


def conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (ref: quat.cpp:40-43)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def rotate_point(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vector p by quaternion q: vec(q * (0,p) * q^-1)
    (ref: quat.cpp:45-47), in the two-cross-product form. For non-unit
    q the reference's q*(0,p)*conj(q) scales by |q|^2; so does this."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = torch.linalg.cross(u, p, dim=-1)
    return (
        p * (w * w - torch.sum(u * u, dim=-1, keepdim=True))
        + 2.0 * u * torch.sum(u * p, dim=-1, keepdim=True)
        + 2.0 * w * uv
    )


def normalize(q: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """q / |q| with guarded denominator."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def slerp(p: torch.Tensor, q: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation with antipodal flip and
    small-angle lerp fallback (ref: quat.cpp:55-74). `t` broadcasts
    against the leading axes of p/q."""
    t = torch.as_tensor(t, dtype=p.dtype, device=p.device)
    if t.dim() == p.dim() - 1:
        t = t[..., None]
    d = torch.sum(p * q, dim=-1, keepdim=True)
    q = torch.where(d < 0.0, -q, q)
    d = torch.abs(d)
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    big = theta > 1e-9
    safe_sin = torch.where(big, sin_theta, 1.0)
    m1 = torch.where(big, torch.sin((1.0 - t) * theta) / safe_sin, 1.0 - t)
    m2 = torch.where(big, torch.sin(t * theta) / safe_sin, t)
    return m1 * p + m2 * q
