#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of the sync engine once on an NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure exits non-zero and prints no result line):
1. the card (nvidia-smi name and power limit), torch/CUDA versions, and
   the build of the CUDA kernels from rssync_tpu_torch/csrc;
2. the main path at the engine's reference operating point (60 s at
   60 fps, 130 features, 200 Hz gyro, 30 windows of 60 frames, PreSync
   over +-200 ms in 2 ms steps, 4 Sync passes) through the entry points
   a user calls: SyncProblem intake, the batched run `run_batched`,
   and one window through pre_sync / 4 x sync / debug_pre_sync. The
   launch counters are zeroed just before and read just after, with
   the shapes each kernel was launched at. The recovered delays must be
   within 0.5 ms of the truth;
3. each kernel against its plain PyTorch version on the card, at every
   shape the main path launched it at, on seeded inputs: max relative
   error of the bracket (<= 2e-6), argmin agreement, kernel and plain
   times;
4. a small clip must give the same delays on the card as on the CPU
   (plain versions) within 0.1 ms;
5. PreSync and Sync(4x) times through the stages `run_batched` chains
   (median of 3 after one warm-up), peak device memory and the outer
   Sync iterations of each pass.

The second-to-last line is a JSON object describing every kernel: its
`ms` and `plain_ms` are those of the heaviest shape the main path
launched it at, and `shapes` holds the measurements at every shape. The
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

#: kernel-vs-plain bound on the bracket (ops/score.py: both sum the
#: mean in one order, so they are expected to be bit-equal)
KERNEL_RTOL = 2e-6
#: engine accuracy target (ms) and card-vs-CPU agreement (ms)
OFFSET_TOL_MS = 0.5
CPU_AGREE_MS = 0.1


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def cuda_ms(fn, torch, reps: int = 5) -> float:
    """Median of `reps` timed calls after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_s(fn, torch, reps: int = 3) -> float:
    """Median host wall time of `reps` synchronized calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def score_inputs(np, torch, seed, B, F, N, I, dev):
    """Row-normalized residual rows, unit hypotheses, counts (with rows
    of 0 and 1 valid features), from a numpy seed."""
    rng = np.random.default_rng(seed)
    P = rng.standard_normal(size=(B, 3, F, N), dtype=np.float32)
    counts = rng.integers(N // 2, N + 1, size=(B, F)).astype(np.int32)
    counts[:, 0] = 0
    counts[:, 1] = 1
    P *= (np.arange(N) < counts[..., None])[:, None]
    n2 = np.sum(P * P, axis=1, keepdims=True)
    P *= np.where(n2 < 1e-24, 1.0, 1.0 / np.sqrt(np.maximum(n2, 1e-30))).astype(np.float32)
    v = rng.standard_normal(size=(B, 3, F, I), dtype=np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return [torch.tensor(x, device=dev) for x in (P, v, counts)]


def compare_kernel(np, torch, S, name, shape, dev, seed):
    """Kernel vs plain version at one (B, F, N, I) launch shape; returns
    the measurements."""
    B, F, N, I = shape
    nP, v, counts = score_inputs(np, torch, seed, B, F, N, I, dev)
    if name == "score_quartile":
        nP, v, counts = nP[0], v[0], counts[0]
        kern, plain = S.score_quartile, S.score_quartile_ref
    else:
        kern, plain = S.score_quartile_batched, S.score_quartile_batched_ref
    got = kern(nP, v, counts)
    want = plain(nP, v, counts)
    torch.cuda.synchronize()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{name}: bad output {tuple(got.shape)}")
    scale = torch.clamp(torch.maximum(got.abs(), want.abs()), min=1e-30)
    rel = float(((got - want).abs() / scale).max())
    agree = float((got.argmin(-1) == want.argmin(-1)).float().mean())
    out = dict(
        B=B, F=F, N=N, I=I, max_rel_err=rel,
        max_abs_err=float((got - want).abs().max()), argmin_agree=agree,
        ms=cuda_ms(lambda: kern(nP, v, counts), torch),
        plain_ms=cuda_ms(lambda: plain(nP, v, counts), torch),
    )
    print(f"# {name} B={B} F={F} N={N} I={I}: max rel err {rel:.3e}, "
          f"argmin agree {agree:.6f}, kernel {out['ms']:.4f} ms, "
          f"plain {out['plain_ms']:.4f} ms", flush=True)
    check(rel <= KERNEL_RTOL, f"{name}: kernel differs from plain version ({rel:.3e})")
    return out


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"PyTorch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("CUDA is not available; this script runs only on a CUDA card")
    try:
        import numpy as np

        from rssync_tpu_torch import create_sync_problem
        from rssync_tpu_torch.ops import _kernels
        from rssync_tpu_torch.ops import score as S
        from rssync_tpu_torch.pipeline.recipe import (
            SYNC_PASSES,
            presync_stage,
            run_batched,
            sync_stage,
            syncpoint_windows,
        )
        from rssync_tpu_torch.testing.engine_problem import (
            OPERATING_POINT,
            PRESYNC_RADIUS_MS,
            PRESYNC_STEP_MS,
            make_engine_problem,
        )
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")
    dev = torch.device("cuda")
    radius_s = PRESYNC_RADIUS_MS / 1000

    # -- phase 1: the card and the build ------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    _kernels.load()
    print(f"# kernel build+load: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_kernels.build_seconds:.2f} s)", flush=True)

    # -- phase 2: the main path at the operating point ----------------------
    t0 = time.perf_counter()
    prob = make_engine_problem(**OPERATING_POINT)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    sp = create_sync_problem(seed=0, device=dev)
    prob.feed(sp)
    window = prob.sync_window
    W = len(prob.syncpoints)
    truth = prob.true_delay
    t_feed = time.perf_counter() - t0
    print(f"# host: problem generation {t_gen:.2f} s, SyncProblem intake {t_feed:.2f} s, "
          f"{W} windows", flush=True)

    S.reset_launch_counters()
    t0 = time.perf_counter()
    delays_ms = run_batched(sp, prob.syncpoints, window, 0.0, True,
                            PRESYNC_RADIUS_MS, PRESYNC_STEP_MS)
    first = prob.syncpoints[0]
    _, d = sp.pre_sync(0.0, first, first + window, PRESYNC_STEP_MS / 1000, radius_s)
    for _ in range(SYNC_PASSES):
        cost, d = sp.sync(d, first, first + window, 0.0, radius_s)
    grid, costs = sp.debug_pre_sync(0.0, first, first + window, radius_s, 200)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    launches = dict(S.LAUNCHES)
    shapes = {k: sorted(v) for k, v in S.LAUNCH_SHAPES.items()}
    print(f"# main path (run_batched + one window's pre_sync/4x sync/debug_pre_sync, "
          f"builds windows): {t_main:.2f} s, launches {launches}, "
          f"launch shapes (B, F, N, I) {shapes}", flush=True)
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")

    errs_ms = np.abs(np.asarray(delays_ms) - 1000 * truth)
    check(len(delays_ms) == W and bool(np.isfinite(errs_ms).all()), "run_batched: bad delays")
    single_err_ms = abs(1000 * (d - truth))
    surface_err_ms = abs(1000 * (grid[int(np.argmin(costs))] - truth))
    print(f"# run_batched max offset error {errs_ms.max():.4f} ms over {W} windows; "
          f"SyncProblem window {first}: {single_err_ms:.4f} ms (cost {cost:.4f}), "
          f"debug_pre_sync argmin {surface_err_ms:.3f} ms off", flush=True)
    check(errs_ms.max() <= OFFSET_TOL_MS, f"offset error {errs_ms.max():.4f} ms")
    check(single_err_ms <= OFFSET_TOL_MS, f"SyncProblem offset error {single_err_ms:.4f} ms")
    check(len(costs) == 200 and bool(np.isfinite(costs).all()), "debug_pre_sync: bad costs")
    check(surface_err_ms <= 4.0, "debug_pre_sync surface minimum far from the truth")

    # -- phase 3: each kernel against its plain version, at every shape the
    # main path launched it at ----------------------------------------------
    compared = {
        name: [compare_kernel(np, torch, S, name, shape, dev, seed)
               for seed, shape in enumerate(shapes[name])]
        for name in shapes
    }

    # -- phase 4: the kernels against the plain versions end to end: a small
    # clip on the card and on the CPU --------------------------------------
    small = make_engine_problem(seed=3, duration=4.0, fps=30.0, n_features=40,
                                sync_window=12, syncpoint_distance=30, true_delay=-0.021)
    per_device = []
    for where in (dev, torch.device("cpu")):
        p = create_sync_problem(seed=0, device=where)
        small.feed(p)
        per_device.append(run_batched(p, small.syncpoints, 12, 0.0, True, 200.0, 2.0))
    agree_ms = float(np.abs(np.subtract(*per_device)).max())
    print(f"# small clip: card vs CPU delays agree to {agree_ms:.6f} ms", flush=True)
    check(agree_ms <= CPU_AGREE_MS, f"card and CPU disagree by {agree_ms:.4f} ms")

    # -- phase 5: stage times at the operating point, through the stages
    # run_batched chains ---------------------------------------------------
    open_wins, closed_wins = syncpoint_windows(sp, prob.syncpoints, window)
    out = {}

    def presync():
        out["presync"] = presync_stage(sp, open_wins, 0.0, PRESYNC_RADIUS_MS, PRESYNC_STEP_MS)

    def sync4():
        out["sync"] = sync_stage(sp, closed_wins, out["presync"], 0.0, radius_s)

    torch.cuda.reset_peak_memory_stats()
    S.reset_launch_counters()
    presync()
    after_presync = dict(S.LAUNCHES)
    sync4()
    torch.cuda.synchronize()
    after_sync = dict(S.LAUNCHES)
    print(f"# launches after PreSync {after_presync}, after Sync(4x) {after_sync}", flush=True)
    check(after_presync["score_quartile_batched"] > 0, "PreSync did not launch the kernel")
    check(after_sync["score_quartile_batched"] > after_presync["score_quartile_batched"],
          "Sync did not launch the kernel")
    t_presync = wall_s(presync, torch)
    t_sync = wall_s(sync4, torch)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    bench_err_ms = float((out["sync"][-1].delay.double() - truth).abs().max()) * 1000
    iters = [int(r.iterations.max()) for r in out["sync"]]
    print(f"# presync: {t_presync:.4f} s  sync(4x): {t_sync:.4f} s  "
          f"max offset err: {bench_err_ms:.4f} ms  peak device memory {peak_gib:.3f} GiB  "
          f"outer iterations per pass {iters} ({card})", flush=True)
    check(bench_err_ms <= OFFSET_TOL_MS, f"timed-run offset error {bench_err_ms:.4f} ms")

    replaces = {"score_quartile": "rssync_tpu/ops/pallas_score.py:139",
                "score_quartile_batched": "rssync_tpu/ops/pallas_score.py:230"}
    kernels = []
    for name, rows in compared.items():
        # the times stated are those of the main path's heaviest launch shape
        heavy = max(rows, key=lambda r: r["B"] * r["F"] * r["I"])
        kernels.append(dict(
            name=name, route="cuda", source="rssync_tpu_torch/csrc/score_quartile.cu",
            replaces=replaces[name], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=heavy["ms"], plain_ms=heavy["plain_ms"], shapes=rows,
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
