"""Sync: fine alternating optimization of per-frame translation
directions and the gyro delay (ref: src/core/core_private.cpp:211-334,
`FrameState::Loss/GuessMotion/GuessK` :92-133, `Backtrack`
src/core_support/backtrack.cpp:3-13).

  init:   motion direction per frame from 200-hypothesis RANSAC, var_k
          from GuessK, both at the initial delay (ref :218-223).
  loop (<= 400 outer iterations, ref :309), over a stack of windows:
    1. IRLS refinement of each frame's direction at the current delay
       (deviation kept from rssync_tpu: the robust loss is
       scale-invariant in M, so its stationary points on the unit
       sphere are the fixed points of "smallest eigenvector of
       A = sum_n w_n P_n P_n^T, w_n = 1/(1+r_n^2)"; solved by adjugate
       inverse iteration on the 3x3 systems);
    2. one Nesterov-momentum (0.3) Armijo-backtracked gradient step on
       the delay (ref :225-226, :298-305); all trials t0 * decay^k are
       evaluated in one batched call and each window keeps its first
       accept, as the reference's sequential loop;
    3. a window stops after 6 consecutive steps < 1e-4 or when its delay
       leaves search_center +- search_radius (ref :316-328).

Windows that have stopped freeze their delay, momentum, motion, counter
and traces while the others run on. The delay gradient is analytic
(autograd through the spline) instead of the reference's central
difference, which cannot survive f32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rssync_tpu_torch.core.problem import SplineTable, TrackWindow, compute_problem
from rssync_tpu_torch.core.ransac import guess_motion_window, guess_motion_window_batched
from rssync_tpu_torch.ops.robust import clamp_k, safe_norm

# --- reference hyperparameters ---------------------------------------------
SYNC_RANSAC_ITERS = 200        # GuessMotion hypotheses (ref :127)
BT_SUFFICIENT_DECREASE = 2e-4  # Backtrack hypers (ref :226)
BT_DECAY = 0.1
BT_INITIAL_STEP = 1e-3
BT_MAX_ITERS = 10
DELAY_MOMENTUM = 0.3           # delay_b (ref :260)
OUTER_MAX_ITERS = 400          # ref :309
CONVERGE_STEP = 1e-4           # ref :316
CONVERGE_COUNT = 5             # ref :321 (`> 5` -> 6 consecutive)

#: IRLS motion rounds per outer iteration (the outer loop re-enters with
#: a warm M, so a few rounds per iteration track the same fixed point)
MOTION_IRLS_ITERS = 3
#: inverse-iteration rounds per IRLS weight update
IRLS_INVIT_ROUNDS = 2


def _pm(P: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """P (..., 3, F, N) . M (..., F, 3) -> (..., F, N)."""
    P0, P1, P2 = P.unbind(-3)
    M0, M1, M2 = (m[..., None] for m in M.unbind(-1))
    return P0 * M0 + P1 * M1 + P2 * M2


def frame_loss(P_f: torch.Tensor, M_f: torch.Tensor, var_k_f) -> torch.Tensor:
    """Full robust loss of one frame: sum log1p((P M)^2 k^2 / |M|^2)
    (ref :99-110 / :117-123). P_f (3, N) with zero padded columns."""
    PM = P_f[0] * M_f[0] + P_f[1] * M_f[1] + P_f[2] * M_f[2]
    # floor keeps ||M||^4 representable in f32 inside the gradient
    M2 = torch.clamp(torch.sum(M_f * M_f), min=1e-12)
    return torch.sum(torch.log1p(PM * PM * (var_k_f * var_k_f) / M2))


def window_loss(
    table: SplineTable, win: TrackWindow, delay, M: torch.Tensor,
    var_k: torch.Tensor,
) -> torch.Tensor:
    """Sum of frame losses over the window(s) at the delay(s)
    (ref :242-254). win may carry a leading window axis W, with delay,
    M (W, F, 3) and var_k (W, F) to match; returns (W,) or ()."""
    P = compute_problem(table, win, delay)
    PM = _pm(P, M)
    M2 = torch.clamp(torch.sum(M * M, dim=-1), min=1e-12)
    losses = torch.sum(torch.log1p(PM * PM * ((var_k * var_k) / M2)[..., None]), dim=-1)
    return torch.sum(losses * win.frame_mask, dim=-1)


# --- batched IRLS motion refinement ----------------------------------------


def _adjugate_apply_sym3(abcdef, v: torch.Tensor) -> torch.Tensor:
    """adj(A) @ v for batched symmetric 3x3 A given as its 6 unique
    entries (a, b, c, d, e, f), each (...); v (..., 3). One inverse
    iteration step up to scale (the det division folds into the
    following normalize)."""
    a, b, c, d, e, f = abcdef
    m00 = d * f - e * e
    m01 = c * e - b * f
    m02 = b * e - c * d
    m11 = a * f - c * c
    m12 = b * c - a * e
    m22 = a * d - b * b
    x, y, z = v.unbind(-1)
    return torch.stack(
        [
            m00 * x + m01 * y + m02 * z,
            m01 * x + m11 * y + m12 * z,
            m02 * x + m12 * y + m22 * z,
        ],
        dim=-1,
    )


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=1e-30))


def motion_irls(
    P: torch.Tensor, M: torch.Tensor, var_k: torch.Tensor,
    iters: int = MOTION_IRLS_ITERS,
) -> torch.Tensor:
    """Refine every frame's translation direction by IRLS.

    The per-frame robust loss sum_n log1p((P_n.M)^2 k^2 / |M|^2)
    (ref :99-110) is scale-invariant in M; on the unit sphere its
    stationary points satisfy A(M) M = lambda_min M with
    A = sum_n w_n P_n P_n^T, w_n = 1/(1 + r_n^2). Each eigenvector
    solve is adjugate inverse iteration on a shifted 3x3. Same fixed
    points as the reference's per-frame L-BFGS (ref :262-296),
    different iterates.

    P (..., 3, F, N) with zero padded columns; M (..., F, 3) warm start;
    var_k (..., F). Returns (..., F, 3) unit directions, sign-aligned
    with the warm start.
    """
    P0, P1, P2 = P.unbind(-3)
    k2 = (var_k * var_k)[..., None]
    for _ in range(iters):
        Mn = _unit(M)
        u = _pm(P, Mn)
        w = 1.0 / (1.0 + u * u * k2)
        wp0, wp1, wp2 = w * P0, w * P1, w * P2
        a = torch.sum(wp0 * P0, dim=-1)
        b = torch.sum(wp0 * P1, dim=-1)
        c = torch.sum(wp0 * P2, dim=-1)
        d = torch.sum(wp1 * P1, dim=-1)
        e = torch.sum(wp1 * P2, dim=-1)
        f = torch.sum(wp2 * P2, dim=-1)
        shift = 1e-6 * (a + d + f) / 3.0 + 1e-30
        B6 = (a + shift, b, c, d + shift, e, f + shift)
        v = Mn
        for _ in range(IRLS_INVIT_ROUNDS):
            v = _unit(_adjugate_apply_sym3(B6, v))
        # keep the antipodal sign stable across iterations
        flip = torch.sum(v * Mn, dim=-1, keepdim=True) < 0.0
        M = torch.where(flip, -v, v)
    return M


# --- delay line search (Backtrack) -----------------------------------------


def _trial_steps(dtype, device) -> torch.Tensor:
    """t0 * decay^k for k < BT_MAX_ITERS, rounded to `dtype`."""
    k = torch.arange(BT_MAX_ITERS, dtype=dtype, device=device)
    return BT_INITIAL_STEP * torch.pow(torch.tensor(BT_DECAY, dtype=dtype, device=device), k)


def _backtrack_step(f_only, x0, fval, grad):
    """One Backtrack::Step per window (ref: backtrack.cpp:3-13):
    returns -t * grad with t from Armijo backtracking.

    The trial steps t0 * decay^k are known in advance, so all of them
    are evaluated in one batched call (trials x windows) and each
    window takes its first accept: the reference's sequential
    selection, without a host sync per trial. A window with no accept
    keeps t0 * decay^BT_MAX_ITERS (effectively zero step), as in the
    reference. f_only maps delays (T, W) to losses (T, W)."""
    ts = _trial_steps(x0.dtype, x0.device)[:, None]  # (T, 1)
    vals = f_only(x0[None] - ts * grad[None])  # (T, W)
    ok = (fval[None] - vals) >= ts * BT_SUFFICIENT_DECREASE * (grad * grad)[None]
    first = torch.argmax(ok.to(torch.int32), dim=0)  # first accept, or 0
    t_fail = torch.full_like(x0, BT_INITIAL_STEP * BT_DECAY ** BT_MAX_ITERS)
    t = torch.where(ok.any(dim=0), ts[first, 0], t_fail)
    return -t * grad


# --- full Sync --------------------------------------------------------------


class SyncResult(NamedTuple):
    cost: torch.Tensor
    delay: torch.Tensor
    iterations: torch.Tensor
    #: per-outer-iteration trace, length OUTER_MAX_ITERS (NaN beyond
    #: `iterations`), the batched-mode replacement for the reference's
    #: per-iteration stderr line (ref :330)
    trace_delay: torch.Tensor
    trace_step: torch.Tensor


def _var_k(P: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """GuessK (ref :125-133): clamp(1e2 / |P M|) per frame."""
    return clamp_k(1e2 / safe_norm(_pm(P, M), dim=-1))


def init_motion(
    table: SplineTable, win: TrackWindow, delay, generator: torch.Generator
) -> tuple[torch.Tensor, torch.Tensor]:
    """GuessMotion (200 RANSAC iterations) + GuessK per frame of one
    window at `delay` (ref :218-223). Returns (M (F, 3), var_k (F,))."""
    P = compute_problem(table, win, delay)  # (3, F, N)
    M = guess_motion_window(P, win.counts, generator, SYNC_RANSAC_ITERS)
    return M, _var_k(P, M)


def init_motion_batched(
    table: SplineTable, wins: TrackWindow, delays: torch.Tensor,
    generator: torch.Generator,
) -> tuple[torch.Tensor, torch.Tensor]:
    """init_motion over a stack of windows (leading W axis), scored in
    one batched kernel call. Returns (M (W, F, 3), var_k (W, F))."""
    P = compute_problem(table, wins, delays)  # (W, 3, F, N)
    M = guess_motion_window_batched(P, wins.counts, generator, SYNC_RANSAC_ITERS)
    return M, _var_k(P, M)


def _loss_and_grad(table, wins, x0, M, var_k):
    """Window losses at delays x0 (W,) and their delay derivatives.
    Windows are independent, so the gradient of the summed loss is
    each window's own derivative."""
    with torch.enable_grad():
        d = x0.detach().requires_grad_(True)
        f = window_loss(table, wins, d, M, var_k)
        (g,) = torch.autograd.grad(f.sum(), d)
    return f.detach(), g


@torch.no_grad()
def sync_loop(
    table: SplineTable, wins: TrackWindow, delay0: torch.Tensor,
    M0: torch.Tensor, var_k: torch.Tensor, centers: torch.Tensor,
    radius: torch.Tensor,
) -> SyncResult:
    """The outer Sync loop over a stack of W windows, from initial
    delays delay0 (W,) and motions M0 (W, F, 3). Runs until every
    window is done or OUTER_MAX_ITERS; the done test costs one host
    sync per iteration."""
    W = delay0.shape[0]
    dtype, dev = delay0.dtype, delay0.device
    delay = delay0.clone()
    v = torch.zeros_like(delay)
    M = M0
    cc = torch.zeros(W, dtype=torch.int32, device=dev)
    done = torch.zeros(W, dtype=torch.bool, device=dev)
    iters = torch.zeros(W, dtype=torch.int32, device=dev)
    tr_d = torch.full((W, OUTER_MAX_ITERS), math.nan, dtype=dtype, device=dev)
    tr_s = torch.full((W, OUTER_MAX_ITERS), math.nan, dtype=dtype, device=dev)

    for i in range(OUTER_MAX_ITERS):
        if bool(done.all()):
            break
        active = ~done
        # 1. motion refinement at the current delay
        P = compute_problem(table, wins, delay)
        M_new = motion_irls(P, M, var_k)
        # 2. Nesterov-lookahead backtracked delay step (ref :298-305)
        x0 = delay - DELAY_MOMENTUM * v
        fval, grad = _loss_and_grad(table, wins, x0, M_new, var_k)
        step = _backtrack_step(
            lambda x: window_loss(table, wins, x, M_new, var_k), x0, fval, grad
        )
        v_new = DELAY_MOMENTUM * v + step
        delay_new = delay + v_new
        cc_new = torch.where(torch.abs(step) < CONVERGE_STEP, cc + 1, 0)
        done_new = (cc_new > CONVERGE_COUNT) | (torch.abs(delay_new - centers) > radius)
        # 3. windows that were done already keep everything as it was
        delay = torch.where(active, delay_new, delay)
        v = torch.where(active, v_new, v)
        M = torch.where(active[:, None, None], M_new, M)
        cc = torch.where(active, cc_new, cc)
        tr_d[:, i] = torch.where(active, delay_new, tr_d[:, i])
        tr_s[:, i] = torch.where(active, step, tr_s[:, i])
        iters = iters + active.to(torch.int32)
        done = done | done_new
    return SyncResult(
        cost=window_loss(table, wins, delay, M, var_k), delay=delay,
        iterations=iters, trace_delay=tr_d, trace_step=tr_s,
    )


def sync_window(
    table: SplineTable, win: TrackWindow, initial_delay, search_center,
    search_radius, generator: torch.Generator,
) -> SyncResult:
    """Full Sync of one window (ref core_private.cpp:211-334). Returns
    scalar cost, delay and iteration count plus (OUTER_MAX_ITERS,)
    traces."""
    dev = win.counts.device
    f32 = dict(dtype=torch.float32, device=dev)
    delay0 = torch.as_tensor(initial_delay, **f32)
    with torch.no_grad():
        M0, var_k = init_motion(table, win, delay0, generator)
    res = sync_loop(
        table, win.map(lambda x: x[None]), delay0[None], M0[None], var_k[None],
        torch.as_tensor(search_center, **f32)[None],
        torch.as_tensor(search_radius, **f32)[None],
    )
    return SyncResult(*(x[0] for x in res))
