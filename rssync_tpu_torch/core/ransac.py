"""RANSAC-style translation-direction guesser, batched over hypotheses
(ref: src/core/core_private.cpp:34-59).

Hypotheses are cross products of two distinct random rows of the raw
residual matrix P; each is scored by the 25th-percentile squared
residual of the row-normalized P against it (the reference code takes
n_rows/4); the best of `iters` hypotheses wins. Scoring is the CUDA
kernel of ops/score.py on the card.

Differences from the reference by design (as in rssync_tpu):
* draws come from an explicit `torch.Generator`, so runs reproduce;
* distinct pairs come from an arithmetic shift instead of a rejection
  loop: r1 drawn from [0, count-2] then incremented when r1 >= r0;
* every hypothesis of every row is scored in one batched call.
"""

from __future__ import annotations

import torch

from rssync_tpu_torch.core.problem import cross_soa
from rssync_tpu_torch.ops.score import score_quartile, score_quartile_batched

#: width of the raw integer draw reduced modulo the pair range; the
#: modulo bias is below count / 2^31
_DRAW_HIGH = 2**31 - 1


def sample_pairs(
    generator: torch.Generator, iters: int, counts: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw `iters` ordered pairs of distinct row indices in [0, count)
    for every entry of `counts` (...,). Returns r0, r1 (..., iters)
    int64. Degenerate rows (count < 2) get indices into [0, 2); callers
    mask those frames out downstream."""
    c = torch.clamp(counts.to(torch.int64), min=2)[..., None]
    shape = (*counts.shape, iters)
    dev = counts.device
    r0 = torch.randint(0, _DRAW_HIGH, shape, generator=generator, device=dev) % c
    r1 = torch.randint(0, _DRAW_HIGH, shape, generator=generator, device=dev) % (c - 1)
    r1 = r1 + (r1 >= r0).to(r1.dtype)
    return r0, r1


def _rsqrt_guarded(n2: torch.Tensor) -> torch.Tensor:
    """1/sqrt(n2), or 1 where n2 < 1e-24 (safe_normalize semantics:
    near-zero vectors stay unnormalized)."""
    return torch.where(n2 < 1e-24, 1.0, torch.rsqrt(torch.clamp(n2, min=1e-30)))


def _score_inputs(P: torch.Tensor, r0: torch.Tensor, r1: torch.Tensor):
    """Row-normalized rows nP (..., 3, F, N) and unit hypotheses
    v (..., 3, F, I) from P (..., 3, F, N) and pairs (..., F, I)."""
    P0, P1, P2 = P.unbind(-3)
    nP = P * _rsqrt_guarded(P0 * P0 + P1 * P1 + P2 * P2)[..., None, :, :]
    # hypothesis rows by index (ref :42-43)
    A = [torch.gather(p, -1, r0) for p in (P0, P1, P2)]
    B = [torch.gather(p, -1, r1) for p in (P0, P1, P2)]
    vx, vy, vz = cross_soa(A, B)
    inv = _rsqrt_guarded(vx * vx + vy * vy + vz * vz)
    v = torch.stack([vx * inv, vy * inv, vz * inv], dim=-3)
    return nP.contiguous(), v.contiguous()


def _pick_best(v: torch.Tensor, med: torch.Tensor) -> torch.Tensor:
    """Winning direction per row: v (..., 3, F, I), scores (..., F, I)
    -> (..., F, 3), with the +z fallback for degenerate rows."""
    best = torch.argmin(med, dim=-1, keepdim=True)  # (..., F, 1)
    idx = best[..., None, :, :].expand(*v.shape[:-1], 1)
    vb = torch.gather(v, -1, idx)[..., 0].transpose(-1, -2)  # (..., F, 3)
    # Degenerate-row guard (deviation from the reference, which keeps a
    # tiny unnormalized cross product, harmless in f64 but fatal in f32:
    # ||M||^4 underflows in the loss gradient). When every hypothesis is
    # near zero, any unit direction fits the zero residuals; pick +z.
    tiny = torch.sum(vb * vb, dim=-1, keepdim=True) < 1e-12
    fallback = vb.new_tensor([0.0, 0.0, 1.0])
    return torch.where(tiny, fallback, vb)


def guess_motion_rows(
    P: torch.Tensor, counts: torch.Tensor, r0: torch.Tensor, r1: torch.Tensor
) -> torch.Tensor:
    """Row-batched guesser core: each of the F rows of P (3, F, N) is an
    independent RANSAC problem with its own pairs r0/r1 (F, iters).
    The row axis may be any flattening of batch axes. Returns (F, 3)."""
    nP, v = _score_inputs(P, r0, r1)
    med = score_quartile(nP, v, counts.to(torch.int32).contiguous())
    return _pick_best(v, med)


def guess_motion_window(
    P: torch.Tensor, counts: torch.Tensor, generator: torch.Generator, iters: int
) -> torch.Tensor:
    """Whole-window guesser: P (3, F, N), counts (F,) -> (F, 3)."""
    r0, r1 = sample_pairs(generator, iters, counts)
    return guess_motion_rows(P, counts, r0, r1)


def guess_motion_window_batched(
    P: torch.Tensor, counts: torch.Tensor, generator: torch.Generator,
    iters: int, pairs: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """A batch of whole-window guessers: P (B, 3, F, N), counts (B, F)
    -> (B, F, 3). `pairs` (r0, r1), each (B, F, iters), replaces the
    draw when given."""
    r0, r1 = pairs if pairs is not None else sample_pairs(generator, iters, counts)
    nP, v = _score_inputs(P, r0, r1)
    med = score_quartile_batched(nP, v, counts.to(torch.int32).contiguous())
    return _pick_best(v, med)
