"""Sync: fine alternating optimization of per-frame translation
directions and the gyro delay (ref: src/core/core_private.cpp:211-334,
`FrameState::Loss/GuessMotion/GuessK` :92-133, `Backtrack`
src/core_support/backtrack.cpp:3-13).

  init:   motion direction per frame from 200-hypothesis RANSAC, var_k
          from GuessK, both at the initial delay (ref :218-223).
  loop (<= 400 outer iterations, ref :309), over a stack of windows:
    1. refinement of each frame's direction at the current delay, by
       `motion_opt`: "irls" (default; deviation kept from rssync_tpu:
       the robust loss is scale-invariant in M, so its stationary points
       on the unit sphere are the fixed points of "smallest eigenvector
       of A = sum_n w_n P_n P_n^T, w_n = 1/(1+r_n^2)"; solved by
       adjugate inverse iteration on the 3x3 systems) or "lbfgs" (the
       reference's per-frame L-BFGS run to MinGradientNorm, ref
       :262-296, every frame of every window a lane of one batch);
    2. one Nesterov-momentum (0.3) Armijo-backtracked gradient step on
       the delay (ref :225-226, :298-305); all trials t0 * decay^k are
       evaluated in one batched call and each window keeps its first
       accept, as the reference's sequential loop. With "irls" the
       momentum restarts (adaptive restart, O'Donoghue & Candes 2015)
       when the step opposes it: IRLS moves the directions of frames
       that barely translate by degrees from trip to trip (14 of a
       window's 61 frames by 1-9 degrees a trip, at 30 fps under pure
       rotation), the delay's loss changes under the step, and the
       reference's momentum then locked into a 4-trip cycle (steps of
       +-1.1 ms and +-0.01 ms) until the outer cap; "lbfgs", whose
       iterates match the reference's, never cycled there and keeps the
       reference's step exactly;
    3. a window stops after 6 consecutive steps < 1e-4 or when its delay
       leaves search_center +- search_radius (ref :316-328).

Windows that have stopped freeze their delay, momentum, motion, counter
and traces while the others run on. The delay gradient is analytic
(autograd through the spline) instead of the reference's central
difference, which cannot survive f32.

A trip (steps 1-3) is one function, `_sync_trip`, over the loop's state.
On a CUDA device with "irls" motion its ~1200 small kernels have fixed
shapes and no host read, so the trip is captured once as a CUDA graph
(over static copies of the inputs and the state, kept per device and
shape) and replayed once a trip: the same kernels in the same order on
the same values, so the results are bit-equal to the eager loop. The
CPU, and "lbfgs" motion (whose loop reads the host), run the trip
eagerly.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rssync_tpu_torch.core.problem import SplineTable, TrackWindow, compute_problem
from rssync_tpu_torch.core.ransac import guess_motion_window, guess_motion_window_batched
from rssync_tpu_torch.ops.robust import clamp_k, safe_norm
from rssync_tpu_torch.utils.graphs import GraphCache
from rssync_tpu_torch.utils.graphs import capture as capture_graphs
from rssync_tpu_torch.utils.timing import NO_SPAN, count, span

# --- reference hyperparameters ---------------------------------------------
SYNC_RANSAC_ITERS = 200        # GuessMotion hypotheses (ref :127)
LBFGS_MAX_ITERS = 200          # ens::L_BFGS MaxIterations (ref :265)
LBFGS_MIN_GRAD = 1e-4          # ens::L_BFGS MinGradientNorm (ref :266)
LBFGS_MEM = 5
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


def frame_losses_and_grads(
    P: torch.Tensor, M: torch.Tensor, var_k: torch.Tensor, frame_mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`frame_loss` of every frame and its analytic gradient in M.

    P (..., 3, F, N), M (..., F, 3), var_k and frame_mask (..., F).
    With u_n = P_n.M, m2 = max(|M|^2, 1e-12) and r_n = u_n^2 k^2 / m2,
    the loss is sum_n log1p(r_n) and its gradient
    2 k^2 / m2 * sum_n u_n / (1 + r_n) * (P_n - u_n M / m2) (the second
    term vanishes where the floor holds m2). Masked frames give 0 and 0.
    Returns losses (..., F) and gradients (..., F, 3).
    """
    PM = _pm(P, M)
    msq = torch.sum(M * M, dim=-1)
    M2 = torch.clamp(msq, min=1e-12)[..., None]
    k2 = (var_k * var_k)[..., None]
    r = PM * PM * k2 / M2
    loss = torch.sum(torch.log1p(r), dim=-1) * frame_mask
    c = PM / (1.0 + r)  # (..., F, N)
    cP = torch.stack([torch.sum(c * Pc, dim=-1) for Pc in P.unbind(-3)], dim=-1)
    cu = torch.sum(c * PM, dim=-1, keepdim=True)
    radial = torch.where((msq > 1e-12)[..., None], cu * M / M2, 0.0)
    grad = (2.0 * k2 / M2) * (cP - radial) * frame_mask[..., None]
    return loss, grad


# --- batched L-BFGS over frames --------------------------------------------

class _LBFGSState(NamedTuple):
    x: torch.Tensor        # (B, d)
    f: torch.Tensor        # (B,)
    g: torch.Tensor        # (B, d)
    S: torch.Tensor        # (B, mem, d) newest first
    Y: torch.Tensor        # (B, mem, d)
    rho: torch.Tensor      # (B, mem)
    hist: torch.Tensor     # (B,) int32 valid history length
    done: torch.Tensor     # (B,) bool


class LBFGSResult(NamedTuple):
    x: torch.Tensor
    #: (B,) iterations each lane ran before it was done; the batch's
    #: loop ran max() of them
    iterations: torch.Tensor


def _two_loop_direction(st: _LBFGSState) -> torch.Tensor:
    """Classic L-BFGS two-loop recursion, batched. Falls back to
    steepest descent when there is no history."""
    mem = st.S.shape[1]
    valid = (torch.arange(mem, device=st.x.device)[None, :] < st.hist[:, None]).to(st.x.dtype)
    q = st.g
    alphas = []
    for i in range(mem):  # newest -> oldest
        a = st.rho[:, i] * torch.sum(st.S[:, i] * q, dim=-1) * valid[:, i]
        q = q - a[:, None] * st.Y[:, i]
        alphas.append(a)
    y0y0 = torch.sum(st.Y[:, 0] * st.Y[:, 0], dim=-1)
    s0y0 = torch.sum(st.S[:, 0] * st.Y[:, 0], dim=-1)
    gamma = torch.where(st.hist > 0, s0y0 / torch.clamp(y0y0, min=1e-30), 1.0)
    r = gamma[:, None] * q
    for i in range(mem - 1, -1, -1):  # oldest -> newest
        b = st.rho[:, i] * torch.sum(st.Y[:, i] * r, dim=-1) * valid[:, i]
        r = r + ((alphas[i] - b) * valid[:, i])[:, None] * st.S[:, i]
    return -r


def _push(hist: torch.Tensor, new: torch.Tensor, store: torch.Tensor) -> torch.Tensor:
    """Where `store`, shift the history (B, mem, ...) one slot older and
    put `new` (B, ...) in slot 0; elsewhere keep it."""
    rolled = torch.cat([new[:, None], hist[:, :-1]], dim=1)
    return torch.where(store.view(-1, *([1] * (hist.dim() - 1))), rolled, hist)


def _all_done(done: torch.Tensor, i: int, check_every: int) -> bool:
    """The loops' exit test, read on the host every `check_every` trips
    (count `host_reads`)."""
    if i % check_every:
        return False
    count("host_reads")
    return bool(done.all())


def batched_lbfgs(
    value_and_grad_fn,
    x0: torch.Tensor,
    max_iters: int = LBFGS_MAX_ITERS,
    min_grad_norm: float = LBFGS_MIN_GRAD,
    mem: int = LBFGS_MEM,
    ls_trials: int = 50,
    armijo_c1: float = 1e-4,
    wolfe_c2: float = 0.9,
    frozen: torch.Tensor | None = None,
    check_every: int = 1,
) -> LBFGSResult:
    """Minimize B independent small problems at once (the role of the
    reference's per-frame ensmallen L-BFGS, ref :262-296): every lane
    steps in lockstep and a lane that is done freezes.

    value_and_grad_fn: (B, d) -> ((B,), (B, d)), safe on frozen lanes.
    The line search follows ensmallen's strong-Wolfe policy from t = 1
    (c1 1e-4, c2 0.9; the step widens x2.1 while the curvature is too
    negative and halves on an Armijo or overshoot failure; <= ls_trials
    trials; a step outside [1e-20, 1e20] freezes the lane), as
    rssync_tpu's batched_lbfgs and the golden shim
    (golden/shim/ensmallen_bits/lbfgs/lbfgs.hpp) do. `frozen` (B,)
    marks lanes done at entry.

    The loops end when every lane is done (or at max_iters / ls_trials
    trips), which costs a host sync per test. They test it every
    `check_every` trips: a trip after every lane is done changes
    nothing (a lane that accepted keeps its step, a done lane its
    state), so the iterates do not depend on it.

    Counts (utils/timing.py): `lbfgs.trips`, the loop's trips, and
    `lbfgs.evaluations`, the value-and-gradient evaluations (the
    start's and each line-search trial's).
    """
    B, d = x0.shape
    f0, g0 = value_and_grad_fn(x0)
    count("lbfgs.evaluations")
    done = safe_norm(g0, dim=-1) < min_grad_norm
    if frozen is not None:
        done = done | frozen
    st = _LBFGSState(
        x=x0, f=f0, g=g0,
        S=x0.new_zeros((B, mem, d)), Y=x0.new_zeros((B, mem, d)),
        rho=x0.new_zeros((B, mem)),
        hist=torch.zeros(B, dtype=torch.int32, device=x0.device),
        done=done,
    )
    iters = torch.zeros(B, dtype=torch.int32, device=x0.device)
    for it in range(max_iters):
        if _all_done(st.done, it, check_every):
            break
        count("lbfgs.trips")
        d_dir = _two_loop_direction(st)
        gd = torch.sum(st.g * d_dir, dim=-1)
        # non-descent direction -> steepest descent restart
        bad = gd >= 0.0
        d_dir = torch.where(bad[:, None], -st.g, d_dir)
        gd = torch.where(bad, -torch.sum(st.g * st.g, dim=-1), gd)

        # strong-Wolfe search from t = 1; the accepted trial's value and
        # gradient are the new point's (the same expression, evaluated
        # once)
        t = x0.new_ones(B)
        accepted = st.done
        t_acc = x0.new_zeros(B)
        f_acc, g_acc = st.f, st.g
        for k in range(ls_trials):
            if _all_done(accepted, k, check_every):
                break
            f_try, g_try = value_and_grad_fn(st.x + t[:, None] * d_dir)
            count("lbfgs.evaluations")
            armijo_fail = f_try > st.f + armijo_c1 * t * gd
            gd_new = torch.sum(g_try * d_dir, dim=-1)
            too_negative = gd_new < wolfe_c2 * gd            # -> widen x2.1
            overshoot = gd_new > -wolfe_c2 * gd              # -> shrink x0.5
            ok = ~armijo_fail & ~too_negative & ~overshoot & ~accepted
            t_acc = torch.where(ok, t, t_acc)
            f_acc = torch.where(ok, f_try, f_acc)
            g_acc = torch.where(ok[:, None], g_try, g_acc)
            t_new = torch.where(accepted | ok, t,
                                torch.where(armijo_fail | overshoot, t * 0.5, t * 2.1))
            # a lane whose step leaves [1e-20, 1e20] has failed: freeze
            # it with t_acc = 0 (it is then done)
            out = (t_new < 1e-20) | (t_new > 1e20)
            accepted = accepted | ok | out
            t = t_new
        took = accepted & ~st.done & (t_acc != 0.0)
        step_t = torch.where(took, t_acc, 0.0)

        x_new = st.x + step_t[:, None] * d_dir
        f_new = torch.where(took, f_acc, st.f)
        g_new = torch.where(took[:, None], g_acc, st.g)
        s = x_new - st.x
        y = g_new - st.g
        sy = torch.sum(s * y, dim=-1)
        was_done = st.done
        store = (sy > 1e-10) & ~was_done
        iters = iters + (~was_done).to(torch.int32)
        g_out = torch.where(was_done[:, None], st.g, g_new)
        st = _LBFGSState(
            x=torch.where(was_done[:, None], st.x, x_new),
            f=torch.where(was_done, st.f, f_new),
            g=g_out,
            S=_push(st.S, s, store), Y=_push(st.Y, y, store),
            rho=_push(st.rho, 1.0 / torch.clamp(sy, min=1e-30), store),
            hist=torch.where(store, torch.clamp(st.hist + 1, max=mem), st.hist),
            done=was_done | (safe_norm(g_out, dim=-1) < min_grad_norm) | (step_t == 0.0),
        )
    return LBFGSResult(st.x, iters)


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


def _backtrack_step(f_only, x0, fval, grad, ts):
    """One Backtrack::Step per window (ref: backtrack.cpp:3-13):
    returns -t * grad with t from Armijo backtracking.

    The trial steps t0 * decay^k are known in advance (`ts`, as
    `_trial_steps` gives them), so all of them are evaluated in one
    batched call (trials x windows) and each window takes its first
    accept: the reference's sequential selection, without a host sync
    per trial. A window with no accept keeps t0 * decay^BT_MAX_ITERS
    (effectively zero step), as in the reference. f_only maps delays
    (T, W) to losses (T, W)."""
    ts = ts[:, None]  # (T, 1)
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
    #: (W,) motion iterations each window ran, summed over the outer
    #: iterations: IRLS rounds, or the L-BFGS loop's trips (the most any
    #: of the window's frames took, as rssync_tpu's per-window loop runs)
    motion_iterations: torch.Tensor


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
    generator: torch.Generator, pairs=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """init_motion over a stack of windows (leading W axis), scored in
    one batched kernel call. pairs: RANSAC index pairs (r0, r1), each
    (W, F, SYNC_RANSAC_ITERS), in place of the draw from `generator`.
    Returns (M (W, F, 3), var_k (W, F))."""
    P = compute_problem(table, wins, delays)  # (W, 3, F, N)
    M = guess_motion_window_batched(P, wins.counts, generator, SYNC_RANSAC_ITERS, pairs=pairs)
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


class _LoopState(NamedTuple):
    """What a trip of `sync_loop` reads and writes, all on the device."""

    delay: torch.Tensor         # (W,)
    v: torch.Tensor             # (W,) the delay's momentum
    M: torch.Tensor             # (W, F, 3)
    cc: torch.Tensor            # (W,) int32 small steps in a row
    done: torch.Tensor          # (W,) bool
    iters: torch.Tensor         # (W,) int32
    motion_iters: torch.Tensor  # (W,) int32
    tr_d: torch.Tensor          # (W, OUTER_MAX_ITERS)
    tr_s: torch.Tensor          # (W, OUTER_MAX_ITERS)
    trip: torch.Tensor          # () int64: trips run, the traces' next column


def _loop_start(delay0: torch.Tensor, M0: torch.Tensor) -> _LoopState:
    """The state before the first trip. M starts contiguous, the layout
    every trip's update gives it (GuessMotion's M0 is a transposed view):
    the card sums `_unit`'s three squares in an order that follows the
    layout, so a trip computes the same on its first pass as on later
    ones, and a captured trip equals every eager one."""
    W = delay0.shape[0]
    dtype, dev = delay0.dtype, delay0.device
    zeros = torch.zeros(W, dtype=torch.int32, device=dev)
    nan = torch.full((W, OUTER_MAX_ITERS), math.nan, dtype=dtype, device=dev)
    return _LoopState(
        delay=delay0.clone(), v=torch.zeros_like(delay0), M=M0.contiguous(), cc=zeros,
        done=torch.zeros(W, dtype=torch.bool, device=dev), iters=zeros.clone(),
        motion_iters=zeros.clone(), tr_d=nan, tr_s=nan.clone(),
        trip=torch.zeros((), dtype=torch.int64, device=dev),
    )


def _unmarked(name: str):
    """`span`'s stand-in where a trip is captured: it records nothing."""
    return NO_SPAN


def _sync_trip(
    table: SplineTable, wins: TrackWindow, var_k: torch.Tensor, centers: torch.Tensor,
    radius: torch.Tensor, ts: torch.Tensor, st: _LoopState, motion_opt: str,
    mark=span,
) -> _LoopState:
    """One trip of the outer loop, steps 1-3 of the module docstring:
    the state after it, in new tensors (`st` is left as it was). ts: the
    backtrack's trial steps (`_trial_steps`). Spans (by `mark`):
    `sync.motion` and `sync.step`."""
    active = ~st.done
    with mark("sync.motion"):
        # 1. motion refinement at the current delay
        P = compute_problem(table, wins, st.delay)
        if motion_opt == "irls":
            M_new = motion_irls(P, st.M, var_k)
            motion_iters = st.motion_iters + MOTION_IRLS_ITERS * active.to(torch.int32)
        else:
            M_new, lane_iters = _motion_lbfgs(P, st.M, var_k, wins.frame_mask, st.done)
            motion_iters = st.motion_iters + lane_iters.amax(dim=-1)
    with mark("sync.step"):
        # 2. Nesterov-lookahead backtracked delay step (ref :298-305)
        v = st.v
        x0 = st.delay - DELAY_MOMENTUM * v
        fval, grad = _loss_and_grad(table, wins, x0, M_new, var_k)
        step = _backtrack_step(
            lambda x: window_loss(table, wins, x, M_new, var_k), x0, fval, grad, ts
        )
        if motion_opt == "irls":  # momentum restart, see the module docstring
            v_new = DELAY_MOMENTUM * torch.where(step * v < 0.0, 0.0, v) + step
        else:
            v_new = DELAY_MOMENTUM * v + step
        delay_new = st.delay + v_new
        cc_new = torch.where(torch.abs(step) < CONVERGE_STEP, st.cc + 1, 0)
        done_new = (cc_new > CONVERGE_COUNT) | (torch.abs(delay_new - centers) > radius)
        # 3. windows that were done already keep everything as it was;
        # the active ones write the trip's column of the traces
        col = active[:, None] & (
            torch.arange(OUTER_MAX_ITERS, device=st.trip.device) == st.trip)
        return _LoopState(
            delay=torch.where(active, delay_new, st.delay),
            v=torch.where(active, v_new, v),
            M=torch.where(active[:, None, None], M_new, st.M),
            cc=torch.where(active, cc_new, st.cc),
            done=st.done | done_new,
            iters=st.iters + active.to(torch.int32),
            motion_iters=motion_iters,
            tr_d=torch.where(col, delay_new[:, None], st.tr_d),
            tr_s=torch.where(col, step[:, None], st.tr_s),
            trip=st.trip + 1,
        )


def _run_trips(st: _LoopState, trip) -> _LoopState:
    """The outer loop: `trip` (state -> state) until every window is
    done or OUTER_MAX_ITERS trips, the done test read on the host before
    each trip (span `sync.done`, count `host_reads`; count `outer_iters`
    a trip)."""
    for _ in range(OUTER_MAX_ITERS):
        with span("sync.done"):
            count("host_reads")
            finished = bool(st.done.all())
        if finished:
            break
        count("outer_iters")
        st = trip(st)
    return st


#: eager trips run on a side stream before a capture
GRAPH_WARMUP_TRIPS = 3
#: the IRLS trip's graphs, one for each input shape
_GRAPHS = GraphCache()


def _use_graph(delay0: torch.Tensor, motion_opt: str) -> bool:
    """Whether `sync_loop` replays a captured trip: CUDA and IRLS."""
    return delay0.is_cuda and motion_opt == "irls"


def _graph_inputs(table, wins, var_k, centers, radius) -> list[torch.Tensor]:
    """The tensors a trip reads besides its state, in a fixed order."""
    return [table.coeffs, table.sample_rate,
            *(getattr(wins, k) for k in TrackWindow.__dataclass_fields__),
            var_k, centers, radius]


class _TripGraph:
    """The IRLS trip captured as one CUDA graph over static copies of its
    inputs (`load` fills them) and of the loop's state, which each replay
    advances in place by one trip."""

    def __init__(self, inputs: list[torch.Tensor], state: _LoopState):
        self.inputs = [torch.empty_like(x) for x in inputs]
        self.state = _LoopState(*(torch.empty_like(x) for x in state))
        coeffs, rate, *rest = self.inputs
        nw = len(TrackWindow.__dataclass_fields__)
        self.table = SplineTable(coeffs=coeffs, sample_rate=rate)
        self.wins = TrackWindow(*rest[:nw])
        self.var_k, self.centers, self.radius = rest[nw:]
        self.ts = _trial_steps(self.state.delay.dtype, self.state.delay.device)
        self.graph = None

    def load(self, inputs: list[torch.Tensor], state: _LoopState) -> None:
        for dst, src in zip([*self.inputs, *self.state], [*inputs, *state]):
            dst.copy_(src)

    def _trip(self) -> _LoopState:
        return _sync_trip(self.table, self.wins, self.var_k, self.centers, self.radius,
                          self.ts, self.state, "irls", _unmarked)

    def capture(self) -> None:
        """Warm up with GRAPH_WARMUP_TRIPS eager trips, then capture a
        trip and its write back into the state (`utils/graphs.capture`)."""
        def warmup():
            for _ in range(GRAPH_WARMUP_TRIPS):
                self._trip()

        def trip():
            for dst, src in zip(self.state, self._trip()):
                dst.copy_(src)

        (self.graph,) = capture_graphs(self.state.delay.device, warmup, [trip])

    def replay(self, st: _LoopState) -> _LoopState:
        count("sync.graph_replays")
        with span("sync.replay"):
            self.graph.replay()
        return st


def _graphed_trips(table, wins, var_k, centers, radius, st: _LoopState) -> _LoopState:
    """`_run_trips` with every trip a replay of the cached graph for the
    inputs' shapes (captured first where there is none: count
    `sync.graph_captures`, span `sync.capture`). Returns copies of the
    final state."""
    inputs = _graph_inputs(table, wins, var_k, centers, radius)
    key = tuple((tuple(x.shape), x.dtype) for x in [*inputs, st.delay, st.M])
    with _GRAPHS.use(st.delay.device, key, lambda: _TripGraph(inputs, st)) as tg:
        tg.load(inputs, st)
        if tg.graph is None:
            count("sync.graph_captures")
            with span("sync.capture"):
                tg.capture()
        end = _run_trips(tg.state, tg.replay)
        return _LoopState(*(x.clone() for x in end))


@torch.no_grad()
def sync_loop(
    table: SplineTable, wins: TrackWindow, delay0: torch.Tensor,
    M0: torch.Tensor, var_k: torch.Tensor, centers: torch.Tensor,
    radius: torch.Tensor, motion_opt: str = "irls",
) -> SyncResult:
    """The outer Sync loop over a stack of W windows, from initial
    delays delay0 (W,) and motions M0 (W, F, 3). Runs until every
    window is done or OUTER_MAX_ITERS; the done test costs one host
    sync per iteration. motion_opt: "irls" (motion_irls) or "lbfgs"
    (batched_lbfgs over every frame of every window, the frames of
    finished windows frozen), as rssync_tpu/core/sync.py:471-474.
    On a CUDA device with "irls" each trip is a replay of one captured
    CUDA graph (module docstring), with the same results.

    Spans: `sync.loop` the call (count `outer_iters`, the loop's trips),
    and in each trip `sync.done` (the done test's host read, count
    `host_reads`), then `sync.motion` (the motion refinement) and
    `sync.step` (the loss, its gradient, the backtracked step and the
    updates), or where the trip is a graph `sync.replay` (count
    `sync.graph_replays` a replay; before the first trip, `sync.capture`
    and count `sync.graph_captures` where the graph is captured)."""
    if motion_opt not in ("irls", "lbfgs"):
        raise ValueError(f"unknown motion_opt {motion_opt!r}")
    with span("sync.loop"):
        st = _loop_start(delay0, M0)
        if _use_graph(delay0, motion_opt):
            st = _graphed_trips(table, wins, var_k, centers, radius, st)
        else:
            ts = _trial_steps(delay0.dtype, delay0.device)
            st = _run_trips(st, lambda s: _sync_trip(
                table, wins, var_k, centers, radius, ts, s, motion_opt))
        return SyncResult(
            cost=window_loss(table, wins, st.delay, st.M, var_k), delay=st.delay,
            iterations=st.iters, trace_delay=st.tr_d, trace_step=st.tr_s,
            motion_iterations=st.motion_iters,
        )


def _motion_lbfgs(P, M, var_k, frame_mask, window_done):
    """batched_lbfgs over every frame of W windows at fixed rows P
    (W, 3, F, N); the frames of windows in `window_done` (W,) are frozen.
    Returns M (W, F, 3) and each lane's iterations (W, F)."""
    W, F = var_k.shape

    def vg(x):
        f, g = frame_losses_and_grads(P, x.view(W, F, 3), var_k, frame_mask)
        return f.reshape(-1), g.reshape(-1, 3)

    res = batched_lbfgs(vg, M.reshape(-1, 3),
                        frozen=window_done[:, None].expand(W, F).reshape(-1))
    return res.x.view(W, F, 3), res.iterations.view(W, F)


def sync_window(
    table: SplineTable, win: TrackWindow, initial_delay, search_center,
    search_radius, generator: torch.Generator, motion_opt: str = "irls",
) -> SyncResult:
    """Full Sync of one window (ref core_private.cpp:211-334). Returns
    scalar cost, delay and iteration count plus (OUTER_MAX_ITERS,)
    traces. motion_opt: "irls" (default) or "lbfgs", the reference's
    per-frame L-BFGS run to MinGradientNorm (see sync_loop)."""
    dev = win.counts.device
    f32 = dict(dtype=torch.float32, device=dev)
    delay0 = torch.as_tensor(initial_delay, **f32)
    with torch.no_grad(), span("sync.init"):
        M0, var_k = init_motion(table, win, delay0, generator)
    res = sync_loop(
        table, win.map(lambda x: x[None]), delay0[None], M0[None], var_k[None],
        torch.as_tensor(search_center, **f32)[None],
        torch.as_tensor(search_radius, **f32)[None], motion_opt,
    )
    return SyncResult(*(x[0] for x in res))
