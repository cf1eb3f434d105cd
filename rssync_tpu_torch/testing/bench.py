"""The headline benchmark on the port: bench.py's workload, a 60 s
GoPro-shaped clip tracked and synced on one CUDA card.

    python -m rssync_tpu_torch.testing.bench

Three stages, in bench.py's order and at its size:
1. tracking: 3600 pairs (15 dispatches of 240, the 60 s clip's 3599
   rounded up to whole dispatches) at 2704x2028 through
   `lk_track_video_chunked` in 16-pair chunks on the 130-point grid
   (step 200). One buffer of 241 u8 noise frames, drawn on the card in
   [0, 255) and stored at the level-0 storage dims (2816x2056), feeds
   every dispatch, as bench.py's does. One dispatch warms up (it builds
   the kernels), then the best of 3 clips, each ending on a host read of
   every dispatch's output;
2. on-video accuracy: `render_scene(seed=5)`, 49 frames of 2704x2028
   rendered on the host (its seconds on a `#` line, outside the stage
   times), padded by `pad_frames_host`, uploaded and tracked by the same
   call; median and p95 error in px against the analytic flow;
3. engine: `make_engine_problem` at the operating point (60 s at 60
   fps, 130 features, 30 windows of 60 frames every 120, delay 42.3
   ms), `batched_presync` over np.arange(-0.2, 0.2, 0.002) and 4
   `batched_sync` passes of radius 0.2 s from its best delays, each
   drawing from a `torch.Generator` seeded as bench.py keys its draws
   (10 + rep for PreSync, 20 + 4 rep + pass for Sync). One warm-up,
   then the best of 3 for each stage, each ending on a host read; the
   max offset error of the last repetition against the truth.

Then K2 and K3 (and K1, where the counters show a launch): the launch
counters are zeroed before the stages and read after each, and the
kernel is held to its plain version (`torch.equal`) on seeded inputs of
every shape it was launched at.

Not ported from bench.py: the donated 8-row `perturb` between
dispatches (it defeats a TPU runtime's dedup of identical executions; a
CUDA stream runs every launch it is given), `wide=True` (the port's
single coefficient gather gives the wide bands' values), the `util`
lines (nominal byte counts of the TPU's layout), the `floors` ratios
(utils/floors.py holds another device's constants) and the Pallas self
test, whose place the kernel check above takes.

`#` lines go to stderr, as bench.py's; the last line on stdout is one
JSON object with bench.py's keys: `metric`, `value` (the three stage
times summed, s), `unit`, `vs_baseline` (2.0 / value, BASELINE.md's
target) and `extras` (`track_s`, `presync_s`, `sync4x_s`,
`offset_err_ms`, `onvideo_track_med_px`, `onvideo_track_p95_px`, and
`ms_per_pair`, `kernels`, `card` (nvidia-smi's name and power limit),
`peak_mem_gib` (the largest stage's `max_memory_allocated`; each
stage's on a `#` line) and `failed`). Without a card it exits 1 and prints no
result; it exits 1 after its JSON line when a check failed: a stage
output of the wrong shape or not finite, an offset error over 0.5 ms,
an on-video error over 0.03 / 0.12 px, K2 or K3 not launched, a kernel
not bit-equal to its plain version.

`run(device="cpu", small=True)` runs the same code at a small size
with the plain versions, each stage once and untimed (no warm-up and
every time None), as the probe harnesses do.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from rssync_tpu_torch.frontend.tracking import (
    LK_ITERS,
    LK_RADIUS,
    _level_plan,
    _stored_dims,
    auto_levels,
    grid_points,
    lk_track_video_chunked,
    pad_frames_host,
)
from rssync_tpu_torch.ops import score as S
from rssync_tpu_torch.ops import strips as ST
from rssync_tpu_torch.parallel.batch import batched_presync, batched_sync, stack_windows
from rssync_tpu_torch.testing import profile_strips as PS
from rssync_tpu_torch.testing.engine_problem import OPERATING_POINT, make_engine_problem
from rssync_tpu_torch.testing.texture_scene import render_scene, tracking_error

METRIC = "60s GoPro-shaped clip: track+presync+sync wall-clock, 1 chip"
#: BASELINE.md's target for the whole clip, s
TARGET_S = 2.0
#: the engine's accuracy target (ms) and the on-video error limits
#: (median, p95; px)
OFFSET_TOL_MS = 0.5
TEX_MED_PX, TEX_P95_PX = 0.03, 0.12
#: timed repetitions of each stage after its warm-up
REPS = 3
SYNC_PASSES = 4
#: PreSync's delay grid (s), as bench.py's np.arange, and Sync's radius
DELAY_GRID = (-0.2, 0.2, 0.002)
SYNC_RADIUS = 0.2
#: the texture scene's seed
TEX_SEED = 5


@dataclass(frozen=True)
class Size:
    """The tracking stage's frames and dispatches, the accuracy stage's
    scene and the engine problem."""

    height: int
    width: int
    grid_step: int
    dispatches: int
    #: pairs a dispatch (its buffer holds seg + 1 frames)
    seg: int
    chunk: int
    tex_frames: int
    tex_height: int
    tex_width: int
    tex_grid_step: int
    engine: dict


FULL = Size(2028, 2704, 200, 15, 240, 16, 49, 2028, 2704, 200, OPERATING_POINT)
#: the tier-1 size: test_torch_tracking.py's 260x400 grid case, 5
#: frames of 120x160, 6 s at 60 fps with 40 features in 3 windows
SMALL = Size(260, 400, 80, 2, 16, 16, 5, 120, 160, 20,
             dict(OPERATING_POINT, duration=6.0, n_features=40))


def stored_dims(height: int, width: int) -> tuple[int, int]:
    """The tracker's level-0 storage dims (bench.py's Hp, Wp)."""
    fine0 = _level_plan(auto_levels(height, width), LK_ITERS, LK_RADIUS)[2]
    return _stored_dims(height, width, "fine" if fine0 else "lane")


def make_noise(size: Size, device, seed: int = 0) -> torch.Tensor:
    """The tracking stage's buffer: seg + 1 u8 noise frames in [0, 255)
    at the storage dims, drawn on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 255, (size.seg + 1, *stored_dims(size.height, size.width)),
                         dtype=torch.uint8, device=device, generator=gen)


def track(frames: torch.Tensor, size: Size) -> torch.Tensor:
    """One dispatch: the buffer's seg pairs, (seg, N, 2)."""
    return lk_track_video_chunked(frames, chunk=size.chunk, grid_step=size.grid_step,
                                  logical_hw=(size.height, size.width))


def onvideo_error(frames: np.ndarray, affines, size: Size, device) -> tuple[float, float]:
    """(median, p95) px error of the rendered scene tracked as the
    tracking stage tracks, against its analytic flow."""
    H, W = size.tex_height, size.tex_width
    chunk = math.gcd(size.chunk, len(frames) - 1)
    tracked = lk_track_video_chunked(
        torch.from_numpy(pad_frames_host(frames)).to(device), chunk=chunk,
        grid_step=size.tex_grid_step, logical_hw=(H, W)).cpu().numpy()
    return tracking_error(tracked, grid_points(W, H, size.tex_grid_step), affines, W, H)


def delay_grid(device) -> torch.Tensor:
    return torch.as_tensor(np.arange(*DELAY_GRID), dtype=torch.float32, device=device)


def engine_rep(table, wins, delays, rep: int) -> tuple[torch.Tensor, float, float]:
    """PreSync, then SYNC_PASSES Sync passes from its best delays (the
    search centered on them), drawing as bench.py's repetition `rep`
    does. Returns (final delays on the host, PreSync s, Sync s), each
    stage ending on a host read."""
    dev = delays.device
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(10 + rep)
    _, best = batched_presync(table, wins, delays, gen)
    best.cpu()
    t_pre = time.perf_counter() - t0
    t0 = time.perf_counter()
    cur = best
    for i in range(SYNC_PASSES):
        gen = torch.Generator(device=dev).manual_seed(20 + SYNC_PASSES * rep + i)
        cur = batched_sync(table, wins, cur, best, SYNC_RADIUS, gen).delay
    final = cur.cpu()
    return final, t_pre, time.perf_counter() - t0


def score_inputs(seed: int, B: int, F: int, N: int, I: int, device) -> list[torch.Tensor]:
    """Row-normalized residual rows, unit hypotheses, counts (with rows
    of 0 and 1 valid features), from a numpy seed: the scoring kernels'
    inputs at one (B, F, N, I) launch shape."""
    rng = np.random.default_rng(seed)
    P = rng.standard_normal(size=(B, 3, F, N), dtype=np.float32)
    counts = rng.integers(N // 2, N + 1, size=(B, F)).astype(np.int32)
    if F > 2:  # one row at F = 1 (the single-frame guessers) keeps its count
        counts[:, 0] = 0
        counts[:, 1] = 1
    P *= (np.arange(N) < counts[..., None])[:, None]
    n2 = np.sum(P * P, axis=1, keepdims=True)
    P *= np.where(n2 < 1e-24, 1.0, 1.0 / np.sqrt(np.maximum(n2, 1e-30))).astype(np.float32)
    v = rng.standard_normal(size=(B, 3, F, I), dtype=np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return [torch.tensor(x, device=device) for x in (P, v, counts)]


def _bit_equal(name: str, shape, seed: int, device) -> bool:
    """The kernel `name` against its plain version on seeded inputs of
    one launch shape (frame indices drawn where T != B)."""
    if name == "gather_strips":
        args = PS.strip_inputs(torch, ST, shape, device, seed, shape[0] != shape[3])
        kern, plain = ST.gather_strips, ST.gather_strips_ref
    else:
        args = score_inputs(seed, *shape, device)
        if name == "score_quartile":
            args = [a[0] for a in args]
            kern, plain = S.score_quartile, S.score_quartile_ref
        else:
            kern, plain = S.score_quartile_batched, S.score_quartile_batched_ref
    return bool(torch.equal(kern(*args), plain(*args)))


def kernel_report(stage_counts: dict, device) -> dict:
    """K2 and K3 (and K1 where launched): launches in all and by stage
    (`stage_counts`: the counters read after each stage), and each launch
    shape with whether the kernel is bit-equal to its plain version
    there (the comparison's own launches come after the read)."""
    shapes = {**S.LAUNCH_SHAPES, **ST.LAUNCH_SHAPES}
    out = {}
    for name in ("score_quartile", "score_quartile_batched", "gather_strips"):
        by_stage, prev = {}, 0
        for stage, counts in stage_counts.items():
            by_stage[stage], prev = counts[name] - prev, counts[name]
        if name == "score_quartile" and not prev:
            continue
        rows = [dict(shape=list(sh), bit_equal=_bit_equal(name, sh, 100 + i, device))
                for i, sh in enumerate(sorted(shapes[name]))]
        out[name] = dict(launches=prev, by_stage=by_stage, shapes=rows,
                         bit_equal=all(r["bit_equal"] for r in rows))
    return out


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip()


def _secs(t: float | None) -> str:
    return "not timed" if t is None else f"{t:.4f}s"


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(device="cuda", small: bool = False) -> dict:
    """The three stages and the kernel check; returns the result line's
    object. On a card every stage is timed (one warm-up, best of
    REPS); elsewhere each runs once and every time is None."""
    dev = torch.device(device)
    timed = dev.type == "cuda"
    if timed and not torch.cuda.is_available():
        raise RuntimeError(f"bench: {dev} requested but CUDA is not available")
    size = SMALL if small else FULL
    failed = []
    card = card_line() if timed else None
    _log(f"# device: {torch.cuda.get_device_name(dev) + ' (' + card + ')' if timed else dev}")
    if timed:
        torch.cuda.reset_peak_memory_stats(dev)
    S.reset_launch_counters()
    ST.reset_launch_counters()
    stage_counts, stage_peaks = {}, {}

    def end_stage(name):
        """Read the launch counters and, on the card, the stage's peak
        device memory."""
        stage_counts[name] = {**S.LAUNCHES, **ST.LAUNCHES}
        if timed:
            stage_peaks[name] = torch.cuda.max_memory_allocated(dev) / 2**30
            torch.cuda.reset_peak_memory_stats(dev)
            _log(f"# {name}: peak device memory {stage_peaks[name]:.3f} GiB")

    # ---- tracking ---------------------------------------------------------
    frames = make_noise(size, dev)
    n_pts = len(grid_points(size.width, size.height, size.grid_step))
    n_pairs = size.dispatches * size.seg
    _log(f"# features/frame: {n_pts}; {size.dispatches} dispatches of {size.seg} pairs at "
         f"{size.width}x{size.height} stored {tuple(frames.shape[1:][::-1])}")

    def clip():
        outs = [track(frames, size) for _ in range(size.dispatches)]
        return [o.cpu() for o in outs]

    track_s = None
    if timed:
        t0 = time.perf_counter()
        track(frames, size).cpu()
        _log(f"# lk build+warmup: {time.perf_counter() - t0:.1f}s")
        track_s = math.inf
        for _ in range(REPS):
            t0 = time.perf_counter()
            outs = clip()
            track_s = min(track_s, time.perf_counter() - t0)
        _log(f"# tracking: {track_s:.4f}s per clip ({1e3 * track_s / n_pairs:.4f} ms/pair)")
    else:
        outs = clip()
    if not all(tuple(o.shape) == (size.seg, n_pts, 2) and bool(torch.isfinite(o).all())
               for o in outs):
        failed.append("tracking output")
    end_stage("track")
    del frames, outs
    if timed:
        torch.cuda.empty_cache()

    # ---- on-video accuracy -------------------------------------------------
    t0 = time.perf_counter()
    tex, affines = render_scene(seed=TEX_SEED, n_frames=size.tex_frames,
                                height=size.tex_height, width=size.tex_width)
    _log(f"# texture scene (host): {time.perf_counter() - t0:.1f}s")
    med_px, p95_px = onvideo_error(tex, affines, size, dev)
    _log(f"# on-video tracking error: med {med_px:.4f} px, p95 {p95_px:.4f} px "
         f"({len(tex) - 1} textured pairs)")
    if not (med_px <= TEX_MED_PX and p95_px <= TEX_P95_PX):
        failed.append("on-video error")
    end_stage("onvideo")
    del tex

    # ---- engine -------------------------------------------------------------
    t0 = time.perf_counter()
    prob = make_engine_problem(**size.engine)
    wins = stack_windows(prob.windows(dev))
    table = prob.table(dev)
    delays = delay_grid(dev)
    _log(f"# problem build (host): {time.perf_counter() - t0:.1f}s, "
         f"{len(prob.syncpoints)} windows")
    presync_s = sync_s = None
    if timed:
        t0 = time.perf_counter()
        _, d = batched_presync(table, wins, delays, torch.Generator(device=dev).manual_seed(1))
        d.cpu()
        batched_sync(table, wins, d, d, SYNC_RADIUS,
                     torch.Generator(device=dev).manual_seed(2)).delay.cpu()
        _log(f"# engine warmup: {time.perf_counter() - t0:.1f}s")
        presync_s = sync_s = math.inf
        for rep in range(REPS):
            final, t_pre, t_sync = engine_rep(table, wins, delays, rep)
            presync_s, sync_s = min(presync_s, t_pre), min(sync_s, t_sync)
    else:
        final = engine_rep(table, wins, delays, 0)[0]
    err_ms = float((final.double() - prob.true_delay).abs().max()) * 1e3
    _log(f"# presync: {_secs(presync_s)}  sync(4x): {_secs(sync_s)}  "
         f"max offset err: {err_ms:.4f} ms")
    if not (tuple(final.shape) == (len(prob.syncpoints),) and err_ms <= OFFSET_TOL_MS):
        _log(f"# WARNING: accuracy above {OFFSET_TOL_MS} ms target")
        failed.append("offset error")
    end_stage("engine")
    del wins, table

    # ---- kernels ------------------------------------------------------------
    kernels = kernel_report(stage_counts, dev)
    for name, k in kernels.items():
        if timed and name != "score_quartile" and not k["launches"]:
            failed.append(f"{name} not launched")
        if not k["bit_equal"]:
            failed.append(f"{name} not bit-equal to its plain version")
        _log(f"# {name}: launches {k['launches']} {k['by_stage']}, bit-equal at "
             f"{sum(r['bit_equal'] for r in k['shapes'])} of {len(k['shapes'])} launch shapes")

    total = track_s + presync_s + sync_s if timed else None
    return {
        "metric": METRIC,
        "value": total,
        "unit": "s",
        "vs_baseline": TARGET_S / total if timed else None,
        "extras": {
            "track_s": track_s,
            "presync_s": presync_s,
            "sync4x_s": sync_s,
            "offset_err_ms": err_ms,
            "onvideo_track_med_px": med_px,
            "onvideo_track_p95_px": p95_px,
            "ms_per_pair": 1e3 * track_s / n_pairs if timed else None,
            "kernels": kernels,
            "card": card,
            "peak_mem_gib": max(stage_peaks.values()) if timed else None,
            "failed": failed,
        },
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: needs a CUDA device", file=sys.stderr)
        return 1
    result = run()
    print(json.dumps(result), flush=True)
    failed = result["extras"]["failed"]
    if failed:
        print(f"bench: FAIL: {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
