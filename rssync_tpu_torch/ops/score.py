"""RANSAC hypothesis scoring: the quartile bracket of squared residuals.

For each row f and hypothesis i the score is an upper bracket `hi` on
the 25th-percentile squared residual s_n = (v . nP_n)^2 over the row's
valid features, found by 12 bisection rounds on a bf16 compare grid
starting from the Markov bracket [0, min(max s, 2.03125 * mean s)].
The caller takes the argmin over hypotheses. This replaces the
reference's per-hypothesis sort and n/4 pick (core_private.cpp:34-59).

Two entry points share one CUDA kernel (csrc/score_quartile.cu):
`score_quartile` for one (3, F, N) problem and `score_quartile_batched`
for a leading batch. On CPU tensors they compute the plain PyTorch
version (`*_ref`); on CUDA tensors they launch the kernel or raise.
`score_quartile_i16` (E8, experiments/r4_i16score.py) is the batched
form with the compare buffer held as bf16 bit patterns compared as
int16; it is on no main path and bit-equal to the others on finite
inputs.

The plain version and the kernel agree bit for bit: the mean is summed
in one fixed pairwise order (`tree_sum`) by both, every multiply and
add is separately rounded, and both sides of each compare are rounded
to bf16 with round-to-nearest-even.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F_

#: bisection rounds on the Markov bracket
BISECT_ROUNDS = 12
#: Markov upper-bracket multiplier: by Markov's inequality more than
#: half the values lie at or below 2 * mean, so the bracket always
#: holds the quartile; the extra 1/64 absorbs bf16 round-up
MARKOV_C = 2.03125

#: kernel launches per wrapper, counted where each wrapper launches
LAUNCHES = {"score_quartile": 0, "score_quartile_batched": 0, "score_quartile_i16": 0}
#: the (B, F, N, I) shapes each wrapper launched its kernel at
LAUNCH_SHAPES = {"score_quartile": set(), "score_quartile_batched": set(),
                 "score_quartile_i16": set()}


def reset_launch_counters() -> None:
    """Zero LAUNCHES and empty LAUNCH_SHAPES."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        LAUNCH_SHAPES[name].clear()


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pairwise order: zero-pad to a
    power of two P, then x[j] += x[j + h] for h = P/2, ..., 1. Padding
    with more zeros leaves the result unchanged, which is how the
    kernel reproduces it for any N."""
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = F_.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _bracket_ref(nP: torch.Tensor, v: torch.Tensor, counts: torch.Tensor,
                 i16: bool) -> torch.Tensor:
    """The plain bracket; with `i16` every compare is of the bf16 bit
    patterns viewed as int16."""
    N = nP.shape[-1]
    n0, n1, n2 = (t[..., None, :] for t in nP.unbind(-3))  # (..., F, 1, N)
    v0, v1, v2 = (t[..., None] for t in v.unbind(-3))      # (..., F, I, 1)
    res = v0 * n0 + v1 * n1 + v2 * n2                      # (..., F, I, N)
    res2 = res * res
    counts = counts.to(torch.int64)
    valid = torch.arange(N, device=nP.device) < counts[..., None, None]
    k1 = (torch.clamp(counts, min=1) // 4 + 1)[..., None]  # (..., F, 1)
    res2m = torch.where(valid, res2, torch.inf).to(torch.bfloat16)
    res2m = res2m.view(torch.int16) if i16 else res2m.float()
    masked = torch.where(valid, res2, 0.0)
    mu = tree_sum(masked) / torch.clamp(counts, min=1)[..., None].to(res2.dtype)
    hi = torch.minimum(masked.amax(dim=-1), MARKOV_C * mu)
    lo = torch.zeros_like(hi)
    for _ in range(BISECT_ROUNDS):
        mid = 0.5 * (lo + hi)
        midq = mid.to(torch.bfloat16)
        midq = midq.view(torch.int16) if i16 else midq.float()
        c = torch.sum(res2m <= midq[..., None], dim=-1)
        ge = c >= k1
        lo = torch.where(ge, lo, mid)
        hi = torch.where(ge, mid, hi)
    return hi


def score_quartile_batched_ref(
    nP: torch.Tensor, v: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version. nP (..., 3, F, N), v (..., 3, F, I),
    counts (..., F) int -> (..., F, I) float32."""
    return _bracket_ref(nP, v, counts, i16=False)


def score_quartile_i16_ref(
    nP: torch.Tensor, v: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """Plain version of `score_quartile_i16`: the bracket with each
    compare bf16(x).view(int16) <= bf16(mid).view(int16). Every
    compared value is +0, positive finite or +inf, whose bits order as
    the values do, so on finite inputs it equals
    `score_quartile_batched_ref` bit for bit; a NaN would order
    differently."""
    return _bracket_ref(nP, v, counts, i16=True)


def score_quartile_ref(
    nP: torch.Tensor, v: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of `score_quartile`: (3, F, N), (3, F, I),
    (F,) -> (F, I)."""
    return score_quartile_batched_ref(nP, v, counts)


def _check(nP, v, counts, lead: int) -> None:
    if nP.dim() != lead + 3 or v.dim() != lead + 3 or counts.dim() != lead + 1:
        raise ValueError(
            f"score_quartile: bad ranks nP {tuple(nP.shape)}, v {tuple(v.shape)}, "
            f"counts {tuple(counts.shape)}"
        )
    if (nP.shape[lead] != 3 or v.shape[lead] != 3
            or nP.shape[:lead] != v.shape[:lead]
            or nP.shape[:lead] != counts.shape[:lead]
            or nP.shape[lead + 1] != v.shape[lead + 1]
            or counts.shape[lead] != nP.shape[lead + 1]):
        raise ValueError(
            f"score_quartile: shape mismatch nP {tuple(nP.shape)}, "
            f"v {tuple(v.shape)}, counts {tuple(counts.shape)}"
        )
    devices = {nP.device, v.device, counts.device}
    if len(devices) != 1:
        raise ValueError(f"score_quartile: tensors on several devices {devices}")


def _launch(nP, v, counts, name: str) -> torch.Tensor:
    """Kernel launch on CUDA tensors nP (B, 3, F, N), v (B, 3, F, I),
    counts (B, F)."""
    from rssync_tpu_torch.ops import _kernels

    dev = nP.device
    if dev.type != "cuda":
        raise ValueError(f"score_quartile: unsupported device {dev}")
    if nP.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"score_quartile: nP/v must be float32, got {nP.dtype}/{v.dtype}")
    if counts.dtype != torch.int32:
        raise TypeError(f"score_quartile: counts must be int32, got {counts.dtype}")
    if not (nP.is_contiguous() and v.is_contiguous() and counts.is_contiguous()):
        raise ValueError("score_quartile: inputs must be contiguous")
    B, _, F, N = nP.shape
    I = v.shape[-1]
    if N < 1:
        raise ValueError("score_quartile: needs at least one feature slot")
    if B * F >= 2**31:
        raise ValueError(f"score_quartile: {B * F} rows exceed the grid limit")
    out = torch.empty((B, F, I), dtype=torch.float32, device=dev)
    if B * F == 0 or I == 0:
        return out
    lib = _kernels.load()
    launch = lib.score_quartile_i16_launch if name == "score_quartile_i16" else \
        lib.score_quartile_launch
    # One thread a (row, hypothesis) task; the C side takes the route
    # (the compare buffer in registers or in shared memory) from N and
    # the tasks a block from the shared memory that needs.
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            nP.data_ptr(), v.data_ptr(), counts.data_ptr(), out.data_ptr(),
            B, F, N, I, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"score_quartile launch failed: {lib.score_quartile_error_string(rc).decode()}"
        )
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[name].add((B, F, N, I))
    return out


def score_quartile(
    nP: torch.Tensor, v: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """Quartile bracket for one problem: nP (3, F, N) row-normalized
    residual rows, v (3, F, I) unit hypotheses, counts (F,) int32 ->
    (F, I) float32. Replaces rssync_tpu/ops/pallas_score.py
    score_quartile_pallas."""
    _check(nP, v, counts, 0)
    if nP.device.type == "cpu":
        return score_quartile_ref(nP, v, counts)
    return _launch(nP[None], v[None], counts[None], "score_quartile")[0]


def score_quartile_batched(
    nP: torch.Tensor, v: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """Quartile bracket for a batch of problems: nP (B, 3, F, N),
    v (B, 3, F, I), counts (B, F) int32 -> (B, F, I) float32. Replaces
    rssync_tpu/ops/pallas_score.py score_quartile_pallas_batched."""
    _check(nP, v, counts, 1)
    if nP.device.type == "cpu":
        return score_quartile_batched_ref(nP, v, counts)
    return _launch(nP, v, counts, "score_quartile_batched")


def score_quartile_i16(
    nP: torch.Tensor, v: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """`score_quartile_batched` with the compare buffer held as bf16 bit
    patterns and compared as int16: the same shapes and, on finite
    inputs, the same result. Replaces experiments/r4_i16score.py
    score_i16."""
    _check(nP, v, counts, 1)
    if nP.device.type == "cpu":
        return score_quartile_i16_ref(nP, v, counts)
    return _launch(nP, v, counts, "score_quartile_i16")
