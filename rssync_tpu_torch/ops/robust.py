"""Robust-loss helpers (ref: src/core_support/inline_utils.hpp:5-50)."""

from __future__ import annotations

import torch

#: RANSAC / loss scale clamp bounds (ref: inline_utils.hpp:49 clamp_k).
K_MIN = 1e1
K_MAX = 1e3


def clamp_k(k: torch.Tensor) -> torch.Tensor:
    """Clamp the residual scale k into [1e1, 1e3] (ref: inline_utils.hpp:49)."""
    return torch.clamp(k, K_MIN, K_MAX)


def safe_normalize(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """v/|v|, returning v unchanged when |v| < 1e-12
    (ref: inline_utils.hpp:5-11)."""
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    return torch.where(n < 1e-12, v, v / torch.clamp(n, min=1e-30))


def safe_norm(v: torch.Tensor, dim=None, eps: float = 1e-30) -> torch.Tensor:
    """|v| with a floor so downstream divisions / gradients stay finite."""
    return torch.clamp(torch.linalg.vector_norm(v, dim=dim), min=eps)
