#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port once on an NVIDIA card: the sync engine,
the LK tracker, rendered frames -> tracks -> sync end to end, telemetry
files -> sync, the reference engine's golden data, the recipe pipeline
(video file -> CSV, its CLI) at full width, the long-term drift run, the
window mesh, the hybrid tracker and bench.py's headline workload.

    python3 chip_smoke.py        # from the repository root, one CUDA card
    python3 chip_smoke.py --parent-csrc DIR   # also time an earlier K3 and E7 source

Phases (any failure exits non-zero and prints no result line):
1. the card (nvidia-smi name and power limit), torch/CUDA versions, the
   build of the CUDA kernels from rssync_tpu_torch/csrc and, at the same
   time, of the native telemetry parser (`make -C native/gpmf`);
2. the engine's main path at its reference operating point (60 s at
   60 fps, 130 features, 200 Hz gyro, 30 windows of 60 frames, PreSync
   over +-200 ms in 2 ms steps, 4 Sync passes) through the entry points
   a user calls: SyncProblem intake, `run_batched`, and one window
   through pre_sync / 4 x sync / debug_pre_sync. The scoring kernels'
   launch counters are zeroed just before and read just after, with
   the shapes they were launched at. Delays within 0.5 ms of the truth;
3. K1/K2 against their plain PyTorch version at every shape phase 2
   launched them at, on seeded inputs: bit-equal (the max relative
   error is printed too), argmin agreement, the kernel's registers and
   local-memory bytes a thread (a spill shows there), kernel and plain
   times (CUDA events, each call after a 1 GiB overwrite: L2 cold,
   queued behind);
4. a small engine problem gives the same delays on the card as on the
   CPU (plain versions) within 0.1 ms, through `run_batched` and through
   PreSync + 4 L-BFGS Sync passes;
5. PreSync and Sync(4x) times through the stages `run_batched` chains
   (median of 3 after one warm-up), peak device memory, outer Sync
   iterations per pass; then, after the same PreSync, 4 Sync passes with
   motion_opt="lbfgs" over all 30 windows (`sync_stage` -> `sync_loop`,
   what rssync_tpu's vmap of sync_window computes), K1/K2 counters zeroed
   just before and read just after: wall time (one run), outer and
   L-BFGS iterations, max offset error <= 0.5 ms, beside IRLS's;
6. the tracker at its operating point: 241 noise frames of 2704x2028
   (stored 2816x2056, made on the card) through
   `lk_track_video_chunked` in 16-pair chunks on the 130-point grid.
   The strip-fetch (K3) counters are zeroed just before and read just
   after; ms per pair is the median of 3 timed runs after that one;
7. tracking accuracy on pixels: a textured affine scene (9 frames of
   2704x2028, rendered on the host) tracked the same way, median and
   p95 error against the analytic flow <= 0.03 / 0.12 px;
8. end to end at full width: a rolling-shutter clip rendered on the
   card (2704x2028, 60 fps, 480 frames, 11.11 ms readout, delay
   42.3 ms, 200 Hz gyro), the pairs of its 4 syncpoint windows tracked
   in 16-pair blocks and emitted into a SyncProblem on the card, the
   gyro log integrated into it, then `run_batched`; every window within
   0.5 ms of the truth. Then the same gyro log from files: written as a
   .gcsv (rssync_tpu's make_clip layout) and as a GoPro GPMF MP4
   (tests/gpmf_fixture.py's writer), each read by `load_gyro` through the
   native and the Python parser (equal arrays; times and the parser that
   served the dispatcher printed) and fed by `fill_gyro` into a SyncProblem
   of the same seed holding the same tracks (through utils/track_cache),
   then `run_batched` with the K2 counters zeroed just before and read
   just after: delays within 0.5 ms of the truth and 0.01 ms of the
   in-memory intake;
9. a small rendered clip (640x480, 26 frames, 30 fps) tracked and
   synced on the card and on the CPU: tracks within 2e-3 px, delays
   within 0.1 ms;
10. K3 against its plain version at every shape phase 6 launched it
    at, plus edge shapes (STRIP_EDGES: float32, every strip at the last
    valid row and block, T != B with random frame indices, one strip,
    a prime strip count, runs past a CTA's index chunk): bit-equal
    (`torch.equal`), kernel, plain and `index_select` times (events, L2
    cold), kernel and `index_select` 200 calls back to back (host
    included), the bound and its share; with --parent-csrc DIR the
    kernel of an earlier gather_strips.cu (the first K3 kernel's C
    interface), built alone, is timed beside (events, and profiler
    durations in phase 23), here and wherever K3 is compared;
11. the probe paths of rssync_tpu_torch/experiments at the tracker's
    operating point (241 frames of 2704x2028 stored 2816x2056, made
    once from a numpy seed), each through its harness's `run` with its
    kernel's counters zeroed just before and read just after: r4_u8pass
    (E5, whole-clip passes), r4_u8pass2 (E6, 15 chunks of 17 frames),
    r4_slice2 (E7, the 15 chunk copies from starts on the card),
    r4_i16score (E8: parity, then PreSync at the engine's operating
    point through K2 and through E8, whose best costs and delays must be
    identical);
12. E5-E8 against their plain versions at every shape their paths
    launched them at (E8 also at the batched-Sync shape B=30, I=200),
    each bit-equal; kernel, plain and library times and the bound; E8
    also against K2's kernel, with K2's time beside its own, and its
    registers and local-memory bytes a thread. E7 is timed beside
    `index_select`, a host-start `narrow().clone()` and, with
    --parent-csrc DIR, the kernel of DIR's copy_block.cu (the first E7
    kernel's C interface, built alone; its copies bit-equal too), each
    behind the 1 GiB zero fill and behind a read-only flush (an int32
    sum over the same buffer: L2 cold but clean), with the bound's
    share of each; then E7 at its edge cases
    (ops/blockcopy.py::copy_edges: n = 1, n = T, the last start,
    one 16-byte frame, a block under one stage, one 16-byte vector past
    a stage on the block and on every CTA, float32), bit-equal;
13. the patch paths of rssync_tpu_torch/experiments, each with its
    kernel's counters zeroed just before and read just after:
    pallas_patch.extract_patches (E1) at mb_extract's 2028x2704 image
    (u8, bf16, f32, made on the card from a numpy seed) and its 130
    origins through force="kernel" and force="gather", equal since no
    clamp moves those origins; r3_dma (E2, K3's kernel on 16 unpadded
    2028x2816 u8 frames: its strips equal the row-block gather);
    mb_extract (E3, 12 variants) and mb_extract2 (E4, the floor, the N
    and size sweeps, the sequential loop, the kernel at nbuf 2/8/16).
    Every variant of mb_extract, and every one of mb_extract2 that
    extracts the main 130 x 40 x 40 set, must give the same float64
    sum, and E4's own check of patches 0, 64, 129 must hold;
14. extract_patches against its plain version at every shape phase 13
    launched it at (each dtype, each patches_per_block), plus one odd
    shape (37x131, 9 patches of 7, bf16, 3 a block), origins with the
    image's corners: bit-equal; kernel, plain and advanced-index gather
    times, the bound, the launch floor (a one-element in-place add timed
    the same way), the kernel's and the floor's times back to back, and
    the registers and local-memory bytes a thread of the instance;
    registers and local bytes of every instance of the kernel; then K3
    at E2's shape through the phase-10 comparison;
15. the reference engine's golden data (tests/golden/golden.npz, six
    scenes of tests/synthetic.py::make_scene built by
    rssync_tpu_torch/testing/golden.py) on the card, K1/K2 counters zeroed
    just before and read just after: P at the five probe delays (<= 5e-5),
    spline samples (<= 2e-5), 4-pass IRLS Sync (<= 2.5e-4 s of the
    reference, <= 5e-4 s of the truth), 4-pass L-BFGS trajectories
    (iterates and steps <= 3e-5, 1e-4 for "interp"; iteration counts
    within 1); every scene's largest error printed beside its limit;
16. the recipe path at full width: phase 8's clip written as rssync_tpu's
    make_clip writes its files (an mp4 through cv2's mp4v writer, the
    .gcsv, the lens file) and a recipe (frame_range [0, 479], sync_window
    60, syncpoint_distance 120, initial_guess 1000 ms, simple PreSync at
    phase 8's radius and step), decoded by the port's own decode layer
    and synced by (a) `run_recipe` batched (its Timings report), (b)
    `run_recipe` sequential, (c) the CLI's `main` twice with --trace and
    a track cache (the second run a cache hit) and (d) `track_frames` on
    the four windows against `track_clip` on the same decoded frames,
    the counters zeroed around each ((a) runs under a recording and
    prints the seconds of the tracking stage's spans): (a) and (b)
    within 0.5 ms of the truth and 0.05 ms of each other, (a) within
    0.1 ms of phase 8's run_batched on the same decoded frames and
    0.15 ms of phase 8's delays on the rendered frames (mp4v is lossy);
    debug.csv 200 rows with its minimum within 5 ms of the truth; the
    CLI's CSVs equal (a)'s and its trace blocks the Sync iterations;
    (d) bit-identical; K3 and K2 launched in (a), K1 in (a)'s debug.csv
    and in (b);
17. guess-orient on phase 16's recipe over frames (0, 60): the clip's
    orientation first, its cost under 0.9 x the runner-up's; then
    run_multi_recipes on phase 16's recipe and a second rendered clip
    (1920x1080, 240 frames at 30 fps, delay -11.7 ms, window 48, its own
    PreSync radius and step): every delay within 0.5 ms of its clip's
    truth. Counters zeroed around each; K2 and K3 launched in both;
18. K1/K2/K3 against their plain versions, bit-equal, at every shape a
    run of phases 16-17 launched them at that phases 3, 10 and 14 did
    not already compare (the counters' launch shapes are read after each
    run of those phases);
19. tests/test_longterm.py's drifting-delay scenario at full size (a
    400 s log at 30 fps drifting 1e-4 s/s, 40 features, 20 windows of 30
    frames, PreSync +-60 ms around 21 ms in 2 ms steps, 4 Sync passes at
    radius 60 ms): max error <= 0.5 ms, mean < 0.2 ms, sync_rmse <
    0.2 ms, spread > 2 ms, fitted slope within 10 % of the drift; then
    guess_motion and guess_motion_from_pairs once on the same pairs
    (K1 at one row, twice): equal, unit;
20. the window mesh at the engine operating point (phase 2's problem,
    PreSync over +-200 ms in 2 ms steps and 4 Sync passes): unsharded,
    batched_sync_pipeline, parallel/mesh.py over make_mesh() (every
    card) and over 5 shards on cuda:0: PreSync best delays within one
    grid step and costs within rtol 1e-4 of the unsharded run, Sync
    delays within 0.01 ms, every delay within 0.5 ms of the truth (the
    wall time of each run and whether each is bit-equal printed); then
    phase 17's two clips as one stacked fleet (sync_clips' PreSync and 4
    Sync passes) sharded 4 ways, and 3 ways padded with pad_to_multiple:
    within 0.01 ms of the unsharded fleet and 0.5 ms of each truth;
21. phase 6's 241 frames through lk_track_video_chunked with
    hybrid=False and hybrid=True: tracks within 2e-3 px (bit-identity
    printed), ms per pair of each, K3 launched over the whole clip with
    frame indices; the hoisted pyramid levels and level-0 templates
    against the first block's (printed);
22. K1/K2/K3 against their plain versions, bit-equal, at every shape
    phases 19-21 launched them at that no earlier phase compared;
23. K3's kernel duration from torch.profiler (and index_select's, and
    the parent's) at every shape phases 10, 14, 18, 22 and 24 compared,
    beside the event time and the bound; then E7's (and the parent E7's,
    index_select's and narrow().clone()'s) at every shape phase 12
    compared; last, since a profiler session may slow the host's later
    launches;
24. (run before phase 23) bench.py's headline workload through
    `rssync_tpu_torch.testing.bench.run` at full size: 3600 tracked pairs
    of 2704x2028 (15 dispatches of 240), the 49-frame textured scene,
    PreSync and 4 Sync passes at the engine operating point, each stage
    timed (one warm-up, best of 3); the counters zeroed just before and
    read after each stage. Its result object on a `# bench:` line;
    offset error <= 0.5 ms, on-video error <= 0.03 / 0.12 px, K2 and K3
    launched and bit-equal to their plain versions at every launch
    shape (the bench's own check), and every check of the bench held;
    then K1/K2/K3 against their plain versions at any launch shape no
    earlier phase compared.

The second-to-last line is a JSON object describing every kernel: its
`ms`, `plain_ms`, `bound_ms` and `library_ms` are those of the heaviest
shape its main path launched it at, and `shapes` holds the measurements
at every shape (a row from phase 18 names the runs that launched its
shape under `path`; phase 22's name phases 19-21). `path` names the
path that launched it, `state` whether its port was also redesigned; the
kernels of the engine and tracker paths also carry `recipe_launches`,
their launches in phase 16 (a), and `bench_launches`, theirs in phase
24 (warm-ups and timed repetitions together). The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

#: engine accuracy target (ms) and card-vs-CPU agreement (ms)
OFFSET_TOL_MS = 0.5
CPU_AGREE_MS = 0.1
#: file intake vs the in-memory intake of the same log (ms)
FILE_AGREE_MS = 0.01
#: the recipe path: batched vs sequential (tests/test_pipeline.py's
#: tolerance) and vs phase 8's run_batched on the rendered frames (ms);
#: debug.csv's cost minimum vs the truth (s)
SEQ_AGREE_MS = 0.05
RECIPE_AGREE_MS = 0.1
SURFACE_TOL_S = 0.005
#: the recipe path vs phase 8's run_batched on the rendered frames (ms):
#: mp4v's lossy coding moves the tracks, and the delays with them, by
#: 0.1043 ms on an H100 (the same in every run: seeded RANSAC, the same
#: frames); the limit leaves that reading a margin of ~50 %
RENDER_AGREE_MS = 0.15
#: this checkout's root: tests/ (make_scene, the GPMF writer, the golden
#: data) and native/gpmf
ROOT = os.path.dirname(os.path.abspath(__file__))
#: card-vs-CPU agreement of tracked positions (px): float32 sums and
#: small matmuls reduce in another order on each device
TRACK_AGREE_PX = 2e-3
#: textured-scene tracking error limits (median, p95), px
TEX_MED_PX, TEX_P95_PX = 0.03, 0.12
#: published H100 SXM peaks: HBM bytes/s; operations/s outside the
#: tensor cores in float32, bf16 and int32 (NVIDIA's H100 white paper,
#: SXM5: 66.9 TFLOP/s, 133.8 TFLOP/s, 33.5 TOP/s)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
BF16_OPS_S = 133.8e12
INT32_OPS_S = 33.5e12
#: operations per (row, hypothesis, valid feature) of K1/K2 (False) and
#: E8 (True), each with the peak of the type it runs in: the residual
#: (3 mul + 2 add), its square, the tree sum and the max in float32; the
#: bf16 quantization; 12 compare-and-count rounds of 2, in bf16 for
#: K1/K2 (set.le / add.rn.bf16x2) and in int16 for E8, two to a 32-bit
#: integer instruction
SCORE_OPS = {
    False: ((8, F32_OPS_S), (1, BF16_OPS_S), (24, BF16_OPS_S)),
    True: ((8, F32_OPS_S), (1, BF16_OPS_S), (24, 2 * INT32_OPS_S)),
}
#: the tracker's operating point (bench.py's tracking stage)
TRACK_HW = (2028, 2704)
GRID_STEP = 200
CHUNK = 16
#: phase 21: phase 6's 241 frames through the hybrid chunk structure
HYBRID_FRAMES = 15 * CHUNK + 1
#: phase 19: tests/test_longterm.py's 400 s log drifting 1e-4 s/s
LONGTERM = dict(seed=4, duration=400.0, fps=30.0, n_features=40, sync_window=30,
                syncpoint_distance=600, true_delay=0.021, delay_drift=1e-4)
#: phase 10: K3's edge shapes, (T, Hp, Wp, B, N, dtype), seed, random
#: frame indices, every strip at the last valid row and block: float32 at
#: the tracker's level-2 shape; every strip at the edge; T != B; one
#: strip; 1163 strips (prime: a ragged last run at any grid); 160 000
#: strips (a CTA's run passes its 128-strip index chunk at 8 CTAs an SM
#: on any card of up to 156 SMs)
STRIP_EDGES = (
    ((16, 536, 768, 16, 130, "torch.float32"), 90, False, False),
    ((16, 536, 768, 16, 130, "torch.uint8"), 91, False, True),
    ((9, 96, 384, 5, 17, "torch.float32"), 99, True, False),
    ((9, 96, 384, 5, 17, "torch.float32"), 95, True, True),
    ((2, 40, 256, 1, 1, "torch.uint8"), 92, True, False),
    ((6, 120, 640, 1, 1163, "torch.uint8"), 93, True, False),
    ((2, 48, 384, 160, 1000, "torch.uint8"), 94, True, False),
)
#: phase 20: sharded vs unsharded Sync delays on the card (ms); the split
#: may reorder a float32 reduction, and 0.01 ms is a tenth of the
#: card-vs-CPU limit
MESH_AGREE_MS = 0.01


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


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


def score_kernel_attrs(N: int, i16: bool) -> dict:
    """Registers and local-memory bytes a thread of the scoring kernel a
    launch at N features takes (csrc/score_quartile.cu picks it from N)."""
    import ctypes

    from rssync_tpu_torch.ops import _kernels

    regs, local = ctypes.c_int(), ctypes.c_int()
    rc = _kernels.load().score_quartile_kernel_attrs(N, int(i16), ctypes.byref(regs),
                                                     ctypes.byref(local))
    check(rc == 0, f"cudaFuncGetAttributes failed ({rc}) for the scoring kernel at N={N}")
    return dict(regs=regs.value, local_bytes=local.value)


def patch_kernel_attrs(itemsize: int, size: int, per_block: int) -> dict:
    """Registers and local-memory bytes a thread of the patch kernel's
    instance for these launch arguments takes (csrc/extract_patches.cu
    picks it from the image type, the size and the depth)."""
    import ctypes

    from rssync_tpu_torch.ops import _kernels

    regs, local = ctypes.c_int(), ctypes.c_int()
    rc = _kernels.load().extract_patches_kernel_attrs(itemsize, size, per_block,
                                                      ctypes.byref(regs), ctypes.byref(local))
    check(rc == 0, f"cudaFuncGetAttributes failed ({rc}) for the patch kernel at "
                   f"({itemsize}, {size}, {per_block})")
    return dict(regs=regs.value, local_bytes=local.value)


def bound(n_bytes: float, n_ops: float, ops_s: float = F32_OPS_S) -> tuple[float, str]:
    """(least ms the card could take, what bounds it) at the published
    peaks: bytes over the HBM rate, operations over `ops_s` (the f32
    rate unless given)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S * 1e3, n_ops / ops_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def score_bound(torch, nP, v, counts, out, i16: bool) -> tuple[float, str]:
    """bound() of K1/K2 (E8 with `i16`): every input read once and the
    output written once; SCORE_OPS for each valid feature of each
    (row, hypothesis), each operation at the peak of its type."""
    N, I = nP.shape[-1], v.shape[-1]
    n_bytes = 4 * (nP.numel() + v.numel() + counts.numel() + out.numel())
    n_feat = I * int(torch.clamp(counts.long(), max=N).sum())
    ops = SCORE_OPS[i16]
    n = sum(k for k, _ in ops)
    return bound(n_bytes, n * n_feat, n / sum(k / rate for k, rate in ops))


def compare_score(np, torch, S, PS, name, shape, dev, seed, flush):
    """K1/K2 vs plain version at one (B, F, N, I) launch shape; returns
    the measurements."""
    from rssync_tpu_torch.testing.bench import score_inputs

    B, F, N, I = shape
    nP, v, counts = score_inputs(seed, B, F, N, I, dev)
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
    bound_ms, bound_by = score_bound(torch, nP, v, counts, got, i16=False)
    equal = bool(torch.equal(got, want))
    out = dict(
        B=B, F=F, N=N, I=I, bit_equal=equal, max_rel_err=rel,
        max_abs_err=float((got - want).abs().max()), argmin_agree=agree,
        ms=PS.event_ms(torch, lambda: kern(nP, v, counts), flush, 5),
        plain_ms=PS.event_ms(torch, lambda: plain(nP, v, counts), flush, 5),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        **score_kernel_attrs(N, False),
    )
    print(f"# {name} B={B} F={F} N={N} I={I}: bit-equal {equal} (max rel err {rel:.3e}), "
          f"argmin agree {agree:.6f}, {out['regs']} registers and {out['local_bytes']} "
          f"local bytes a thread, kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    check(equal, f"{name}: kernel differs from plain version (max rel err {rel:.3e})")
    return out


def compare_strips(np, torch, ST, PS, shape, dev, seed, random_fidx, flush, parent=None,
                   edge=False):
    """K3 vs plain version at one (T, Hp, Wp, B, N, dtype) launch shape
    (with `edge`, every strip at the last valid row and block), and
    `index_select` over the (T * Hp * Wp/128, 128) row view fetching the
    same strips; with `parent` (an earlier gather_strips.cu built by
    profile_strips.build_parent) its kernel's event time beside. Event
    times, and 200 calls back to back (host included) of the kernel's
    wrapper and of index_select; the profiler's durations come in phase
    23. Returns the measurements."""
    T, Hp, Wp, B, N, dtype = shape
    img, oyq, obx, fidx = PS.strip_inputs(torch, ST, shape, dev, seed, random_fidx, edge)

    def kern():
        return ST.gather_strips(img, oyq, obx, fidx)

    got = kern()
    want = ST.gather_strips_ref(img, oyq, obx, fidx)
    lib_fn, idx = PS.index_select_call(torch, ST, img, oyq, obx, fidx)
    lib = lib_fn()
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want)) and bool(torch.equal(lib, want))
    n_bytes = PS.strips_bytes(torch, ST, img, idx, B, N)
    bound_ms, bound_by = bound(n_bytes, 0)
    out = dict(
        T=T, Hp=Hp, Wp=Wp, B=B, N=N, dtype=dtype, random_fidx=random_fidx, edge=edge,
        seed=seed, bit_equal=equal,
        max_abs_err=float((got.float() - want.float()).abs().max()),
        ms=PS.event_ms(torch, kern, flush, 20),
        plain_ms=PS.event_ms(torch, lambda: ST.gather_strips_ref(img, oyq, obx, fidx), flush,
                             20),
        library_ms=PS.event_ms(torch, lib_fn, flush, 20),
        bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes,
        back_to_back_ms=PS.back_to_back(torch, kern)[0],
        library_back_to_back_ms=PS.back_to_back(torch, lib_fn)[0],
    )
    parent_txt = ""
    if parent is not None:
        pfn = PS.parent_call(torch, parent, img, oyq, obx, fidx)
        check(bool(torch.equal(pfn(), want)), f"the parent K3 differs from plain at {shape}")
        out["parent_ms"] = PS.event_ms(torch, pfn, flush, 20)
        parent_txt = f", parent kernel {out['parent_ms']:.4f} ms"
    print(f"# gather_strips T={T} Hp={Hp} Wp={Wp} B={B} N={N} {dtype} "
          f"fidx={'random' if random_fidx else 'arange'}{' edge' if edge else ''}: bit-equal "
          f"{equal}, kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, index_select "
          f"{out['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({n_bytes / 1e6:.2f} MB), "
          f"share {bound_ms / out['ms']:.3f}; back to back (host included) kernel "
          f"{out['back_to_back_ms']:.4f} ms, index_select "
          f"{out['library_back_to_back_ms']:.4f} ms{parent_txt}", flush=True)
    check(equal, f"gather_strips differs from its plain version at {shape}"
                 f"{' (edge)' if edge else ''}")
    return out


def profile_strips_rows(torch, ST, PS, dev, rows, parent, card) -> None:
    """Phase 23: the profiler's kernel duration of K3 (and of index_select
    and the parent K3, where given) at the inputs of every compared row,
    remade from its seed; added to the rows. Last, because a profiler
    session may leave tracing hooks that slow the host's later launches."""
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    for r in rows:
        shape = (r["T"], r["Hp"], r["Wp"], r["B"], r["N"], r["dtype"])
        inputs = PS.strip_inputs(torch, ST, shape, dev, r["seed"], r["random_fidx"], r["edge"])
        r["profiler_ms"] = PS.profiler_ms(torch, lambda: ST.gather_strips(*inputs), flush)
        r["library_profiler_ms"] = PS.profiler_ms(
            torch, PS.index_select_call(torch, ST, *inputs)[0], flush)
        if parent is not None:
            r["parent_profiler_ms"] = PS.profiler_ms(
                torch, PS.parent_call(torch, parent, *inputs), flush)
        prof = r["profiler_ms"]
        print(f"# gather_strips {shape}{' edge' if r['edge'] else ''}: kernel event "
              f"{r['ms']:.4f} ms, profiler {PS.fmt_ms(prof)} ms (bound {r['bound_ms']:.4f}, "
              f"share {r['bound_ms'] / r['ms']:.3f} by event"
              + (f", {r['bound_ms'] / prof:.3f} by profiler" if prof else "")
              + f"); index_select profiler {PS.fmt_ms(r['library_profiler_ms'])} ms"
              + (f"; parent event {r['parent_ms']:.4f} ms, profiler "
                 f"{PS.fmt_ms(r['parent_profiler_ms'])} ms" if parent is not None else "")
              + f" ({card})", flush=True)
    del flush


def compare_convert(np, torch, CV, PS, shape, dev, seed, flush):
    """E5/E6 vs plain version at one launch shape; the plain version is
    the library call `.to(torch.bfloat16)` itself."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
    got = CV.u8_to_bf16(x)
    want = CV.u8_to_bf16_ref(x)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    n_bytes = 3 * x.numel()  # u8 read, bf16 written
    bound_ms, bound_by = bound(n_bytes, x.numel())
    plain_ms = PS.event_ms(torch, lambda: CV.u8_to_bf16_ref(x), flush, 5)
    out = dict(
        shape=list(shape), bit_equal=equal,
        max_abs_err=float((got.float() - want.float()).abs().max()),
        ms=PS.event_ms(torch, lambda: CV.u8_to_bf16(x), flush, 5), plain_ms=plain_ms,
        library_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes,
    )
    print(f"# u8_to_bf16 {tuple(shape)}: bit-equal {equal}, kernel {out['ms']:.4f} ms, "
          f"plain/.to(bfloat16) {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({n_bytes / 1e6:.1f} MB)", flush=True)
    check(equal, f"u8_to_bf16 differs from its plain version at {shape}")
    return out


def copy_library_calls(torch, frames, start, n) -> dict:
    """{name: call} of the two PyTorch calls that compute E7's copy:
    index_select with the start on the card, narrow().clone() with it
    on the host (read here, once)."""
    idx = start.long() + torch.arange(n, device=frames.device)
    s = int(start.item())
    return {"index_select": lambda: torch.index_select(frames, 0, idx),
            "narrow_clone": lambda: frames.narrow(0, s, n).clone()}


def copy_calls(torch, BC, PS, frames, start, n, parent) -> dict:
    """{name: call} of E7's kernel, the library calls and, with `parent`
    (an earlier copy_block.cu, PS.build_parent_copy), the parent kernel."""
    calls = {"kernel": lambda: BC.copy_block(frames, start, n),
             **copy_library_calls(torch, frames, start, n)}
    if parent is not None:
        calls["parent"] = PS.parent_copy_call(torch, parent, frames, start, n)
    return calls


def compare_copy(np, torch, BC, PS, shape, dev, seed, flush, chunk, parent=None):
    """E7 vs plain version at one (T, Hp, Wp, n, dtype) launch shape: every
    chunk start of the path bit-equal (the parent kernel's too); at the
    middle start the kernel, `index_select`, a host-start
    `narrow(...).clone()` and the parent kernel, each timed behind the
    1 GiB zero fill and behind the read-only flush (an int32 sum over
    it), with its share of the bound; the profiler's durations come in
    phase 23."""
    T, Hp, Wp, n, dtype = shape
    check(dtype == "torch.uint8", f"copy_block: unexpected dtype {dtype}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    frames = torch.randint(0, 256, (T, Hp, Wp), dtype=torch.uint8, device=dev, generator=gen)
    starts = [torch.tensor([s], dtype=torch.int32, device=dev)
              for s in range(0, T - n + 1, chunk)]
    errs, parent_equal = [], True
    for st in starts:
        got, want = BC.copy_block(frames, st, n), BC.copy_block_ref(frames, st, n)
        errs.append(float((got.float() - want.float()).abs().max()))
        if parent is not None:
            parent_equal &= bool(torch.equal(
                PS.parent_copy_call(torch, parent, frames, st, n)(), want))
    torch.cuda.synchronize()
    equal = max(errs) == 0.0
    check(parent_equal, f"the parent E7 differs from plain at {shape}")
    st = starts[len(starts) // 2]
    n_bytes = 2 * n * Hp * Wp + 4
    bound_ms, bound_by = bound(n_bytes, 0)
    times = {}
    for name, fn in copy_calls(torch, BC, PS, frames, st, n, parent).items():
        zero = PS.event_ms(torch, fn, flush, 20)
        clean = PS.event_ms(torch, fn, flush, 20, read_only=True)
        times[name] = dict(ms=zero, read_only_ms=clean, share=bound_ms / zero,
                           read_only_share=bound_ms / clean)
    out = dict(
        T=T, Hp=Hp, Wp=Wp, n=n, dtype=dtype, seed=seed, starts=len(starts),
        start=int(st.item()), bit_equal=equal,
        max_abs_err=max(errs), ms=times["kernel"]["ms"],
        plain_ms=PS.event_ms(torch, lambda: BC.copy_block_ref(frames, st, n), flush, 20),
        library_ms=times["index_select"]["ms"], narrow_clone_ms=times["narrow_clone"]["ms"],
        bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes, times=times,
    )
    print(f"# copy_block T={T} {Hp}x{Wp} n={n}: {len(starts)} starts bit-equal {equal}"
          f"{', parent too' if parent is not None else ''}, plain {out['plain_ms']:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({n_bytes / 1e6:.1f} MB)", flush=True)
    for name, r in times.items():
        print(f"#   {name}: event {r['ms']:.4f} ms (share {r['share']:.3f}), read-only flush "
              f"{r['read_only_ms']:.4f} ms (share {r['read_only_share']:.3f})", flush=True)
    check(equal, f"copy_block differs from its plain version at {shape}")
    return out


def compare_copy_edges(torch, BC, dev) -> None:
    """E7 vs plain version at its edge cases (blockcopy.copy_edges):
    bit-equal, or the run fails."""
    for i, (label, shape, dtype, s, n) in enumerate(BC.copy_edges(BC.sm_count(dev))):
        frames = BC.edge_frames(shape, dtype, dev, 60 + i)
        st = torch.tensor([s], dtype=torch.int32, device=dev)
        equal = bool(torch.equal(BC.copy_block(frames, st, n), BC.copy_block_ref(frames, st, n)))
        ctas = BC.copy_plan(n * frames[0].numel() * frames.element_size(), BC.sm_count(dev))
        print(f"# copy_block edge {label}: {tuple(shape)} {dtype} start {s} n {n}, {ctas} "
              f"CTAs: bit-equal {equal}", flush=True)
        check(equal, f"copy_block differs from its plain version at the edge case {label}")


def profile_copy_rows(torch, BC, PS, dev, rows, parent, card) -> None:
    """Phase 23: the profiler's kernel duration of E7, the parent E7
    (where given), index_select and narrow().clone() at the inputs of
    every compared row, remade from its seed; added to the rows."""
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    for r in rows:
        gen = torch.Generator(device=dev).manual_seed(r["seed"])
        frames = torch.randint(0, 256, (r["T"], r["Hp"], r["Wp"]), dtype=torch.uint8,
                               device=dev, generator=gen)
        st = torch.tensor([r["start"]], dtype=torch.int32, device=dev)
        n = r["n"]
        for name, fn in copy_calls(torch, BC, PS, frames, st, n, parent).items():
            prof = PS.profiler_ms(torch, fn, flush)
            r["times"][name]["profiler_ms"] = prof
            print(f"# copy_block T={r['T']} n={n} {name}: event {r['times'][name]['ms']:.4f} ms, "
                  f"read-only flush {r['times'][name]['read_only_ms']:.4f} ms, profiler "
                  f"{PS.fmt_ms(prof)} ms"
                  + (f" (share {r['bound_ms'] / prof:.3f})" if prof else "") + f" ({card})",
                  flush=True)
    del flush


def compare_i16(np, torch, S, PS, shape, dev, seed, flush):
    """E8 vs its plain version and vs K2's kernel at one (B, F, N, I)
    shape; K2 and E8 timed in turns (K2, E8, E8, K2)."""
    from rssync_tpu_torch.testing.bench import score_inputs

    B, F, N, I = shape
    nP, v, counts = score_inputs(seed, B, F, N, I, dev)
    got = S.score_quartile_i16(nP, v, counts)
    want = S.score_quartile_i16_ref(nP, v, counts)
    k2 = S.score_quartile_batched(nP, v, counts)
    torch.cuda.synchronize()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"score_quartile_i16: bad output {tuple(got.shape)}")
    equal, equal_k2 = bool(torch.equal(got, want)), bool(torch.equal(got, k2))
    bound_ms, bound_by = score_bound(torch, nP, v, counts, got, i16=True)

    def e8():
        S.score_quartile_i16(nP, v, counts)

    def k2_call():
        S.score_quartile_batched(nP, v, counts)

    k2_a, e8_a = PS.event_ms(torch, k2_call, flush, 5), PS.event_ms(torch, e8, flush, 5)
    e8_b, k2_b = PS.event_ms(torch, e8, flush, 5), PS.event_ms(torch, k2_call, flush, 5)
    out = dict(
        B=B, F=F, N=N, I=I, bit_equal=equal, bit_equal_k2=equal_k2,
        max_abs_err=float((got - want).abs().max()),
        ms=(e8_a + e8_b) / 2, k2_ms=(k2_a + k2_b) / 2,
        plain_ms=PS.event_ms(torch, lambda: S.score_quartile_i16_ref(nP, v, counts), flush, 5),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        **score_kernel_attrs(N, True),
    )
    print(f"# score_quartile_i16 B={B} F={F} N={N} I={I}: bit-equal to plain {equal}, to K2 "
          f"{equal_k2}; {out['regs']} registers and {out['local_bytes']} local bytes a thread; "
          f"E8 {out['ms']:.4f} ms ({e8_a:.4f}, {e8_b:.4f}), K2 {out['k2_ms']:.4f} "
          f"ms ({k2_a:.4f}, {k2_b:.4f}), plain {out['plain_ms']:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    check(equal and equal_k2, f"score_quartile_i16 differs at {shape}")
    return out


def compare_patches(np, torch, PT, PS, shape, dev, seed, flush):
    """extract_patches vs its plain version at one (H, W, N, size,
    dtype, patches_per_block) launch shape, origins in bounds from a
    numpy seed with the image's four corners first; the advanced-index
    gather (in the image dtype) as the library call; the launch floor,
    a one-element in-place add timed like the kernel behind the same
    flush; the kernel's and the floor's times back to back."""
    H, W, N, size, dtype, ppb = shape
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if dtype == "torch.uint8":
        img = torch.randint(0, 256, (H, W), dtype=torch.uint8, device=dev, generator=gen)
    else:
        img = (torch.randn((H, W), device=dev, generator=gen) * 50).to(getattr(torch, dtype[6:]))
    o = np.stack([rng.integers(0, W - size + 1, N), rng.integers(0, H - size + 1, N)], axis=1)
    corners = np.asarray([[0, 0], [W - size, 0], [0, H - size], [W - size, H - size]])
    o[: min(N, 4)] = corners[: min(N, 4)]
    o = torch.tensor(o, dtype=torch.int32, device=dev)
    got = PT.extract_patches(img, o, size, patches_per_block=ppb)
    want = PT.extract_patches_ref(img, o, size)
    ar = torch.arange(size, device=dev)
    ri = (o[:, 1].long()[:, None] + ar)[:, :, None]
    ci = (o[:, 0].long()[:, None] + ar)[:, None, :]
    lib = img[ri, ci]
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want)) and bool(torch.equal(lib.float(), want))
    # bytes: each image pixel the patches cover, read once; the patches
    # written as float32; the origins read
    covered = int(torch.unique(ri * W + ci).numel()) * img.element_size()
    n_bytes = covered + got.numel() * 4 + o.numel() * 4
    bound_ms, bound_by = bound(n_bytes, 0)
    one = torch.zeros(1, device=dev)

    def kernel():
        PT.extract_patches(img, o, size, patches_per_block=ppb)

    def floor():
        one.add_(1)

    out = dict(
        H=H, W=W, N=N, size=size, dtype=dtype, patches_per_block=ppb, bit_equal=equal,
        max_abs_err=float((got - want).abs().max()),
        ms=PS.event_ms(torch, kernel, flush, 20),
        plain_ms=PS.event_ms(torch, lambda: PT.extract_patches_ref(img, o, size), flush, 20),
        library_ms=PS.event_ms(torch, lambda: img[ri, ci], flush, 20),
        floor_ms=PS.event_ms(torch, floor, flush, 20),
        back_to_back_ms=PS.back_to_back(torch, kernel)[0],
        floor_back_to_back_ms=PS.back_to_back(torch, floor)[0],
        bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes,
        **patch_kernel_attrs(img.element_size(), size, ppb),
    )
    print(f"# extract_patches {H}x{W} N={N} size={size} {dtype} per_block={ppb}: bit-equal "
          f"{equal}, kernel {out['ms']:.4f} ms, launch floor {out['floor_ms']:.4f} ms (one "
          f"launch behind a flush each), back to back {out['back_to_back_ms']:.4f} ms (floor "
          f"{out['floor_back_to_back_ms']:.4f}), plain {out['plain_ms']:.4f} ms, "
          f"advanced-index gather {out['library_ms']:.4f} ms, bound {bound_ms:.6f} ms "
          f"({n_bytes / 1e6:.3f} MB), {out['regs']} registers, {out['local_bytes']} local "
          f"bytes a thread", flush=True)
    check(equal, f"extract_patches differs from its plain version at {shape}")
    return out


class TrackRecorder:
    """A problem that keeps what `set_track_result` is given."""

    def __init__(self):
        self.calls = {}

    def set_track_result(self, frame, *data):
        self.calls[int(frame)] = data


def collect_shapes(seen: dict, label: str, *counters) -> None:
    """Add every shape in the counters' LAUNCH_SHAPES to `seen`
    (kernel -> shape -> the labels of the runs that launched it)."""
    for c in counters:
        for name, shapes in c.LAUNCH_SHAPES.items():
            for sh in shapes:
                seen.setdefault(name, {}).setdefault(sh, []).append(label)


def run_cli(CLI, argv) -> tuple[str, str]:
    """`python -m rssync_tpu_torch.pipeline` in this process: (stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = CLI.main(argv)
    check(rc == 0, f"the CLI exited {rc}")
    return out.getvalue(), err.getvalue()


def trace_windows(err: str) -> list[tuple[int, int, int, int]]:
    """(pass, window, iterations in the header, delay-step lines after
    it) of every `# pass` block the CLI's --trace printed."""
    lines = err.splitlines()
    heads = [i for i, ln in enumerate(lines) if ln.startswith("# pass ")]
    out = []
    for k, i in enumerate(heads):
        _, _, pas, _, win, n, _ = lines[i].replace("(", "").split()
        end = heads[k + 1] if k + 1 < len(heads) else len(lines)
        body = [ln for ln in lines[i + 1 : end] if len(ln.split()) == 2]
        out.append((int(pas), int(win), int(n), len(body)))
    return out


def recipe_phase(np, torch, dev, card, clip, phase8_ms, S, ST, TR, RC, CLI, Timings,
                 write_clip_files, radius_ms, step_ms, tmp, seen) -> tuple[dict, dict, str]:
    """Phase 16: phase 8's clip written as rssync_tpu's make_clip writes
    its files (an mp4 through cv2's mp4v writer, the .gcsv, the lens
    file) and synced from them by the port's front door: (a)
    run_recipe batched, (b) run_recipe sequential, (c) the CLI twice
    with --trace and a track cache (the second run a cache hit), (d)
    track_frames against track_clip on the decoded frames. Every run
    decodes the mp4 with the port's own decode layer (cv2 is on the
    card's host): nothing stands in for it. Files go to `tmp`. The
    shapes every run launched K1/K2/K3 at go into `seen`
    (collect_shapes). Returns the kernels' launches in (a), (a)'s recipe
    and the track cache."""
    import cv2

    t1 = time.perf_counter()
    files = write_clip_files(clip, tmp)
    t_write = time.perf_counter() - t1
    truth_ms = 1000 * clip.true_delay
    sync_window = 60

    def recipe(name):
        return {
            "input": {
                "video_path": files.video_path, "gyro_path": files.gyro_path,
                "gyro_orientation": clip.orient, "frame_range": [0, clip.n_frames - 1],
                "lens_profile": {"path": files.lens_path, "name": files.lens_name},
                "initial_guess": 1000.0, "use_simple_presync": True,
                "simple_presync_radius": radius_ms, "simple_presync_step": step_ms,
            },
            "params": {"sync_window": sync_window, "syncpoints_format": "auto",
                       "syncpoint_distance": 120},
            "output": {"csv_path": os.path.join(tmp, f"{name}.csv"),
                       "debug_csv_path": os.path.join(tmp, f"{name}_debug.csv")},
        }

    print(f"# recipe path frame source: {files.video_path} ({os.path.getsize(files.video_path)}"
          f" B, {clip.n_frames} frames {clip.width}x{clip.height} through cv2 "
          f"{cv2.__version__}'s mp4v writer in {t_write:.2f} s), decoded by the port's "
          f"VideoSource / DecodePool; nothing substituted", flush=True)

    def zero():
        S.reset_launch_counters()
        ST.reset_launch_counters()

    def counts():
        return {**S.LAUNCHES, **ST.LAUNCHES}

    # (a) batched, recorded: the tracking stage's spans
    from rssync_tpu_torch.utils.timing import recording

    zero()
    timings = Timings()
    t1 = time.perf_counter()
    with recording() as rec:
        res_a = RC.run_recipe(recipe("a"), batched=True, timings=timings)
    t_a = time.perf_counter() - t1
    launches_a = counts()
    collect_shapes(seen, "recipe (a)", S, ST)
    print(f"# (a) run_recipe batched: {t_a:.2f} s; launches {launches_a}; delays "
          f"{[round(d, 4) for d in res_a.delays_ms]} ms, truth {truth_ms:.4f} ms ({card})",
          flush=True)
    for line in timings.report().splitlines():
        print(f"#     {line}", flush=True)
    for name, s in rec.summary().items():
        if name.startswith("track."):
            print(f"#     span {name}: {s['calls']} calls, {s['total_s']:.4f} s, self "
                  f"{s['self_s']:.4f} s, counts {s['counts']}", flush=True)
    # (b) sequential
    zero()
    timings_b = Timings()
    t1 = time.perf_counter()
    res_b = RC.run_recipe(recipe("b"), batched=False, timings=timings_b)
    t_b = time.perf_counter() - t1
    launches_b = counts()
    collect_shapes(seen, "recipe (b)", S, ST)
    print(f"# (b) run_recipe sequential: {t_b:.2f} s (sync_all "
          f"{timings_b.stages['sync_all'].total_s:.2f} s, tracking "
          f"{timings_b.stages['tracking'].total_s:.2f} s); launches {launches_b}; delays "
          f"{[round(d, 4) for d in res_b.delays_ms]} ms ({card})", flush=True)
    # (c) the CLI twice, the second run from the track cache
    cache = os.path.join(tmp, "track_cache")
    results = []
    real_sync_stage = RC.sync_stage

    def recording_sync_stage(*a, **k):
        out = real_sync_stage(*a, **k)
        results.append(out)
        return out

    RC.sync_stage = recording_sync_stage
    cli = []
    try:
        for name in ("c1", "c2"):
            path = os.path.join(tmp, f"{name}.json")
            with open(path, "w") as f:
                json.dump(recipe(name), f)
            zero()
            t1 = time.perf_counter()
            out, err = run_cli(CLI, [path, "--trace", "--track-cache", cache])
            cli.append((time.perf_counter() - t1, out, err, counts(),
                        open(recipe(name)["output"]["csv_path"]).read()))
            collect_shapes(seen, f"recipe ({name})", S, ST)
    finally:
        RC.sync_stage = real_sync_stage
    print(f"# (c) CLI --trace --track-cache: {cli[0][0]:.2f} s (tracks computed, launches "
          f"{cli[0][3]}), {cli[1][0]:.2f} s (cache hit, launches {cli[1][3]}) ({card})",
          flush=True)
    # (d) track_frames against track_clip on the decoded frames
    ranges = RC.window_pair_ranges(res_a.syncpoints, sync_window)
    src = TR.VideoSource(files.video_path)
    n_dec = ranges[-1][1] + 1
    frames = torch.zeros((n_dec, clip.height, clip.width), dtype=torch.uint8, device=dev)
    ts = np.zeros(n_dec)
    for b, e in ranges:
        for fr in src.frames(b, e + 1):
            frames[fr.index] = torch.from_numpy(fr.gray).to(dev)
            ts[fr.index] = fr.timestamp
    src.close()
    lens = RC.load_lens_profile(files.lens_path, files.lens_name)
    got, want = TrackRecorder(), TrackRecorder()
    zero()
    t1 = time.perf_counter()
    TR.track_frames(got, lens, files.video_path, 0, clip.n_frames - 1, ranges=ranges)
    torch.cuda.synchronize()
    t_tf = time.perf_counter() - t1
    launches_d = counts()
    collect_shapes(seen, "recipe (d)", S, ST)
    TR.track_clip(want, lens, frames, ts, ranges)
    same = sorted(got.calls) == sorted(want.calls) == [p for b, e in ranges
                                                       for p in range(b, e)]
    same = same and all(np.array_equal(x, y) for f, d in want.calls.items()
                        for x, y in zip(got.calls[f], d))
    # phase 8's path (in-memory gyro, run_batched) on the decoded frames'
    # tracks: the recipe's inputs, where phase 8 read the rendered frames
    sp = RC.SyncProblem(seed=0, device=dev)
    RC.set_gyro_rates(sp, clip.gyro_ts, clip.gyro_rates, clip.orient)
    for f, d in want.calls.items():
        sp.set_track_result(f, *d)
    decoded_ms = np.asarray(RC.run_batched(sp, res_a.syncpoints, sync_window, 1.0, True,
                                           radius_ms, step_ms))
    print(f"# (d) track_frames on {len(ranges)} windows ({len(got.calls)} pairs): {t_tf:.2f} s, "
          f"launches {launches_d}; frame data bit-identical to track_clip on the decoded "
          f"frames: {same} ({card})", flush=True)

    # checks
    a, b = np.asarray(res_a.delays_ms), np.asarray(res_b.delays_ms)
    check(res_a.syncpoints == res_b.syncpoints == [0, 120, 240, 360],
          f"recipe syncpoints {res_a.syncpoints} / {res_b.syncpoints}")
    err_a, err_b = np.abs(a - truth_ms), np.abs(b - truth_ms)
    ab, a8 = float(np.abs(a - b).max()), float(np.abs(a - phase8_ms).max())
    a_dec = float(np.abs(a - decoded_ms).max())
    dbg = np.loadtxt(res_a.debug_csv_path, delimiter=",", ndmin=2)
    surface = abs(dbg[int(np.argmin(dbg[:, 1])), 0] - clip.true_delay)
    print(f"# recipe checks: errors (a) {err_a.round(4).tolist()} (b) {err_b.round(4).tolist()} "
          f"ms (<= {OFFSET_TOL_MS}); (a) vs (b) {ab:.4f} ms (<= {SEQ_AGREE_MS}); (a) vs "
          f"phase 8's run_batched on the decoded frames {a_dec:.4f} ms (<= "
          f"{RECIPE_AGREE_MS}); on the rendered frames, before mp4v coding, {a8:.4f} ms (<= "
          f"{RENDER_AGREE_MS}); "
          f"debug.csv {dbg.shape[0]} rows, "
          f"minimum {1000 * surface:.3f} ms from the truth (<= {1000 * SURFACE_TOL_S:g})",
          flush=True)
    check(bool(np.isfinite(err_a).all()) and err_a.max() <= OFFSET_TOL_MS,
          f"recipe (a) offset error {err_a.max():.4f} ms")
    check(bool(np.isfinite(err_b).all()) and err_b.max() <= OFFSET_TOL_MS,
          f"recipe (b) offset error {err_b.max():.4f} ms")
    check(ab <= SEQ_AGREE_MS, f"batched and sequential recipes differ by {ab:.4f} ms")
    check(a_dec <= RECIPE_AGREE_MS,
          f"recipe and phase 8's path on the decoded frames differ by {a_dec:.4f} ms")
    check(a8 <= RENDER_AGREE_MS,
          f"recipe and phase 8's run_batched on the rendered frames differ by {a8:.4f} ms")
    check(dbg.shape == (200, 2) and surface <= SURFACE_TOL_S, "debug.csv: bad surface")
    a_csv = open(res_a.csv_path).read()
    check(cli[0][4] == cli[1][4] == a_csv, "the CLI's CSVs differ from each other or from (a)")
    check(cli[0][1].endswith(a_csv) and cli[1][1].endswith(a_csv),
          "the CLI's stdout does not end with the CSV")
    for k, (_, _, err, _, _) in enumerate(cli):
        blocks = trace_windows(err)
        want_blocks = [(i, p, int(r.iterations[w]), int(r.iterations[w]))
                       for i, r in enumerate(results[k]) for w, p in enumerate(res_a.syncpoints)]
        check(blocks == want_blocks, f"CLI run {k + 1}: trace blocks {blocks} != {want_blocks}")
    check(cli[1][3]["gather_strips"] == 0, "the second CLI run tracked: no cache hit")
    check(same, "track_frames differs from track_clip on the decoded frames")
    check(launches_a["gather_strips"] > 0, "recipe (a): K3 was not launched")
    check(launches_a["score_quartile_batched"] > 0, "recipe (a): K2 was not launched")
    check(launches_a["score_quartile"] > 0, "recipe (a): K1 (debug.csv) was not launched")
    check(launches_b["score_quartile"] > 0, "recipe (b): K1 was not launched")
    check(launches_d["gather_strips"] > 0, "track_frames: K3 was not launched")
    print("# recipe " + json.dumps({
        "card": card, "stages_a": timings.as_dict(), "stages_b": timings_b.as_dict(),
        "a_s": t_a, "b_s": t_b, "cli_s": [c[0] for c in cli], "track_frames_s": t_tf,
        "write_mp4_s": t_write, "delays_a_ms": res_a.delays_ms,
        "delays_b_ms": res_b.delays_ms, "truth_ms": truth_ms,
        "phase8_decoded_ms": decoded_ms.tolist(), "phase8_rendered_ms": phase8_ms.tolist(),
        "launches_a": launches_a, "launches_b": launches_b}), flush=True)
    return launches_a, recipe("a"), cache


def guess_multi_phase(np, torch, card, clip, recipe, cache, S, ST, RC, GO, make_clip,
                      write_clip_files, tmp, seen) -> list:
    """Phase 17: guess-orient on phase 16's recipe over frames (0, 60),
    then run_multi_recipes on phase 16's recipe (its tracks from the
    phase's track cache) and a second rendered clip with other
    settings, the counters zeroed just before each and read just after;
    the shapes each launched K1/K2/K3 at go into `seen`. Returns the
    fleet's (recipe, clip) pairs."""
    S.reset_launch_counters()
    ST.reset_launch_counters()
    t1 = time.perf_counter()
    ranked = GO.run_guess_orient(recipe, frames=(0, 60))
    t_go = time.perf_counter() - t1
    go_launches = {**S.LAUNCHES, **ST.LAUNCHES}
    collect_shapes(seen, "guess-orient", S, ST)
    print(f"# guess-orient over frames (0, 60), 48 variants: {t_go:.2f} s, launches "
          f"{go_launches}; top 3 {[(o, round(c, 4)) for c, _, o in ranked[:3]]} ({card})",
          flush=True)
    check(len(ranked) == 48 and ranked[0][2] == clip.orient,
          f"guess-orient ranked {ranked[0][2]} first, not {clip.orient}")
    check(ranked[0][0] < 0.9 * ranked[1][0], "guess-orient: the runner-up is too close")
    check(go_launches["score_quartile_batched"] > 0, "guess-orient: K2 was not launched")
    check(go_launches["gather_strips"] > 0, "guess-orient: K3 was not launched")

    t1 = time.perf_counter()
    # 240 frames at 30 fps: its gyro log spans clip 1's 10 s, so neither
    # table is edge-padded (stack_problems refuses a padded table's
    # windows within |initial guess| + radius of its ends, and the
    # schedules start at frame 0 with a 1 s guess)
    clip2 = make_clip(seed=9, true_delay=-0.0117, fps=30.0, n_frames=240, width=1920,
                      height=1080, gyro_rate=200.0, readout=0.01111, pad=2.0)
    files2 = write_clip_files(clip2, os.path.join(tmp, "clip2"))
    t_clip2 = time.perf_counter() - t1
    recipe2 = copy.deepcopy(recipe)
    recipe2["input"].update(video_path=files2.video_path, gyro_path=files2.gyro_path,
                            frame_range=[0, clip2.n_frames - 1],
                            lens_profile={"path": files2.lens_path, "name": files2.lens_name},
                            simple_presync_radius=150.0, simple_presync_step=3.0)
    recipe2["params"].update(sync_window=48, syncpoint_distance=60)
    recipe2["output"] = {"csv_path": os.path.join(tmp, "multi2.csv")}
    recipe1 = copy.deepcopy(recipe)
    recipe1["output"] = {"csv_path": os.path.join(tmp, "multi1.csv")}
    S.reset_launch_counters()
    ST.reset_launch_counters()
    t1 = time.perf_counter()
    res = RC.run_multi_recipes([recipe1, recipe2], track_cache_dir=cache)
    t_multi = time.perf_counter() - t1
    launches = {**S.LAUNCHES, **ST.LAUNCHES}
    collect_shapes(seen, "multi-clip", S, ST)
    errs = [np.abs(np.asarray(r.delays_ms) - 1000 * c.true_delay)
            for r, c in zip(res, (clip, clip2))]
    print(f"# run_multi_recipes: clip 2 ({clip2.width}x{clip2.height}, {clip2.n_frames} frames at "
          f"{clip2.fps:g} fps, seed 9, truth {1000 * clip2.true_delay:.4f} ms, window 48, PreSync +-150 ms in 3 ms "
          f"steps) rendered + written {t_clip2:.2f} s; multi run {t_multi:.2f} s (clip 1's "
          f"tracks from the cache), launches {launches}; syncpoints "
          f"{[r.syncpoints for r in res]}, errors {[e.round(4).tolist() for e in errs]} ms "
          f"({card})", flush=True)
    check([r.syncpoints for r in res] == [[0, 120, 240, 360], [0, 60, 120, 180]],
          f"multi-clip syncpoints {[r.syncpoints for r in res]}")
    for e in errs:
        check(bool(np.isfinite(e).all()) and e.max() <= OFFSET_TOL_MS,
              f"multi-clip offset error {e.max():.4f} ms")
    check(launches["score_quartile_batched"] > 0, "run_multi_recipes: K2 was not launched")
    check(launches["gather_strips"] > 0, "run_multi_recipes: K3 (clip 2's tracks) was not launched")
    return [(recipe1, clip), (recipe2, clip2)]


def compare_new_shapes(np, torch, S, ST, PS, dev, seen, covered, seed0, label,
                       parent) -> dict:
    """K1/K2/K3 against their plain versions at every launch shape in
    `seen` that `covered` lacks (then added to it); each row's `path`
    names the runs that launched its shape. Returns {kernel: rows}."""
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    rows = {name: [] for name in covered}
    for name in covered:
        new = sorted(sh for sh in seen.get(name, {}) if sh not in covered[name])
        print(f"# {name}: {len(seen.get(name, {}))} launch shapes in {label}, "
              f"{len(new)} not compared before: {new}", flush=True)
        for i, sh in enumerate(new):
            if name == "gather_strips":  # frame indices matter where T != B
                row = compare_strips(np, torch, ST, PS, sh, dev, seed0 + i, sh[0] != sh[3],
                                     flush, parent)
            else:
                row = compare_score(np, torch, S, PS, name, sh, dev, seed0 + i, flush)
            row["path"] = sorted(set(seen[name][sh]))
            rows[name].append(row)
        covered[name] |= set(new)
    del flush
    return rows


def longterm_phase(np, torch, dev, card, S, R, B, make_engine_problem, compute_problem,
                   sync_rmse, seen) -> None:
    """Phase 19: tests/test_longterm.py's 400 s drifting-delay log on the
    card (PreSync +-60 ms around 21 ms in 2 ms steps, 4 Sync passes at
    radius 60 ms around each window's PreSync best), then the
    single-frame guessers once (K1 at one row); counters zeroed just
    before each and read just after."""
    prob = make_engine_problem(**LONGTERM)
    wins = B.stack_windows(prob.windows(dev))
    table = prob.table(dev)
    W = len(prob.syncpoints)
    grid = torch.tensor(np.arange(-0.06, 0.06, 0.002) + LONGTERM["true_delay"],
                        dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    S.reset_launch_counters()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, best = B.batched_presync(table, wins, grid, gen)
    cur = best
    for _ in range(4):
        cur = B.batched_sync(table, wins, cur, best, 0.06, gen).delay
    got = cur.double().cpu().numpy()
    t_run = time.perf_counter() - t1
    launches = dict(S.LAUNCHES)
    collect_shapes(seen, "19 long-term drift", S)
    t_centers = (np.asarray(prob.syncpoints) + prob.sync_window / 2) / prob.fps
    truth = prob.delay_at(t_centers)
    err_ms = np.abs(got - truth) * 1e3
    q = sync_rmse(np.asarray(prob.syncpoints, np.float64), got * 1e3)
    spread = float(np.std(got * 1e3))
    slope = float(np.polyfit(t_centers, got, 1)[0])
    drift = LONGTERM["delay_drift"]
    print(f"# long-term drift (400 s log, {W} windows, timestamps to "
          f"{float(t_centers[-1]):.1f} s): PreSync + 4 Sync {t_run:.2f} s, launches {launches}; "
          f"error max {err_ms.max():.4f} ms mean {err_ms.mean():.4f} ms, sync_rmse "
          f"{q.rmse:.4f} ms, spread {spread:.3f} ms, slope {slope:.4e} s/s (drift {drift:g}) "
          f"({card})", flush=True)
    check(bool(np.isfinite(got).all()) and len(got) == W >= 15, "long-term: bad delays")
    check(err_ms.max() <= OFFSET_TOL_MS, f"long-term: max error {err_ms.max():.4f} ms")
    check(err_ms.mean() < 0.2, f"long-term: mean error {err_ms.mean():.4f} ms")
    check(q.rmse < 0.2, f"long-term: sync_rmse {q.rmse:.4f} ms")
    check(spread > 2.0, f"long-term: spread {spread:.3f} ms, the drift is missing")
    check(abs(slope - drift) < 0.1 * drift, f"long-term: slope {slope:.4e} s/s")
    check(launches["score_quartile_batched"] > 0, "long-term: K2 was not launched")

    # the single-frame guessers: frame 0 of window 0 at its PreSync best
    P = compute_problem(table, wins.map(lambda x: x[0]), best[0])[:, 0]  # (3, N)
    count = int(wins.counts[0, 0])
    S.reset_launch_counters()
    r0, r1 = R.sample_pairs(torch.Generator(device=dev).manual_seed(1), 200,
                            torch.tensor(count, device=dev))
    m_pairs = R.guess_motion_from_pairs(P, count, r0, r1)
    m_full = R.guess_motion(P, count, torch.Generator(device=dev).manual_seed(1), 200)
    k1 = S.LAUNCHES["score_quartile"]
    collect_shapes(seen, "19 guess_motion", S)
    m_cpu = R.guess_motion_from_pairs(P.cpu(), count, r0.cpu(), r1.cpu())
    cpu_diff = float((m_pairs.cpu() - m_cpu).abs().max())
    print(f"# guess_motion / guess_motion_from_pairs (N={P.shape[1]}, {count} valid, 200 "
          f"hypotheses): K1 launches {k1}, equal {bool(torch.equal(m_pairs, m_full))}, "
          f"|M| {float(torch.linalg.vector_norm(m_pairs)):.7f}, card vs CPU on the same "
          f"pairs {cpu_diff:.3e}", flush=True)
    check(k1 == 2, f"the single-frame guessers launched K1 {k1} times, not 2")
    check(torch.equal(m_pairs, m_full), "guess_motion differs from guess_motion_from_pairs")
    check(abs(float(torch.linalg.vector_norm(m_pairs)) - 1.0) < 1e-5, "guess_motion: not unit")


def mesh_phase(np, torch, dev, card, S, B, M, MU, create_sync_problem, prob,
               syncpoint_windows, presync_grid, fleet, radius_s, step_s, seen) -> None:
    """Phase 20: the engine operating point through the window mesh:
    make_mesh() (every card) and 5 shards on cuda:0, beside the unsharded
    run and batched_sync_pipeline; then phase 17's two-clip fleet
    stacked and sharded 4 ways, and 3 ways padded with pad_to_multiple.
    Counters zeroed just before each run and read just after."""
    sp = create_sync_problem(seed=0)
    prob.feed(sp)
    ow, cw = syncpoint_windows(sp, prob.syncpoints, prob.sync_window)
    table = sp.spline_table
    W = ow.counts.shape[0]
    grid = torch.tensor(presync_grid(0.0, radius_s, step_s), dtype=torch.float32, device=dev)
    centers = torch.zeros(W, device=dev)

    def unsharded(gen):
        cost, best = B.batched_presync(table, ow, grid, gen)
        cur = best
        for _ in range(4):
            cur = B.batched_sync(table, cw, cur, centers, radius_s, gen).delay
        return cost, best, cur

    def pipeline(gen):
        best, res = B.batched_sync_pipeline(table, ow, cw, grid, 0.0, radius_s, gen)
        return None, best, res[-1].delay

    def sharded(mesh):
        def run(gen):
            cost, best = M.sharded_presync(table, ow, grid, gen, mesh)
            cur = best
            for _ in range(4):
                cur = M.sharded_sync(table, cw, cur, centers, radius_s, gen, mesh).delay
            return cost, best, cur
        return run

    mesh1 = M.make_mesh()
    runs = [("unsharded", unsharded), ("batched_sync_pipeline", pipeline),
            (f"make_mesh() ({mesh1.size} card)", sharded(mesh1)),
            ("5 shards on cuda:0", sharded(M.make_mesh(["cuda:0"] * 5)))]
    out = {}
    for name, fn in runs:
        S.reset_launch_counters()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out[name] = fn(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = dict(S.LAUNCHES)
        collect_shapes(seen, f"20 mesh: {name}", S)
        cost, best, cur = out[name]
        err = float((cur.double() - prob.true_delay).abs().max()) * 1e3
        line = f"# mesh at the engine operating point, {name}: {wall:.3f} s, launches {launches}"
        if name != "unsharded":
            cost_u, best_u, cur_u = out["unsharded"]
            d_best = float((best - best_u).abs().max())
            d_sync = float((cur - cur_u).abs().max()) * 1e3
            line += (f"; vs unsharded: PreSync best bit-equal {bool(torch.equal(best, best_u))} "
                     f"(max {d_best * 1e3:.4f} ms), Sync delays bit-equal "
                     f"{bool(torch.equal(cur, cur_u))} (max {d_sync:.6f} ms)")
            check(d_best <= step_s + 1e-9, f"mesh {name}: PreSync best {d_best} s from unsharded")
            check(d_sync <= MESH_AGREE_MS, f"mesh {name}: Sync {d_sync:.6f} ms from unsharded")
            if cost is not None:
                rel = float(((cost - cost_u).abs() / cost_u.abs().clamp(min=1e-30)).max())
                line += (f", PreSync costs bit-equal {bool(torch.equal(cost, cost_u))} "
                         f"(rel {rel:.3e})")
                check(rel <= 1e-4, f"mesh {name}: PreSync costs rel {rel:.3e} from unsharded")
        print(f"{line}; max offset error {err:.4f} ms ({card})", flush=True)
        check(err <= OFFSET_TOL_MS, f"mesh {name}: offset error {err:.4f} ms")
        check(launches["score_quartile_batched"] > 0, f"mesh {name}: K2 was not launched")

    # phase 17's fleet as parallel/multi.py::sync_clips runs it (one PreSync
    # over per-window grids around each clip's initial guess, 4 Sync passes
    # at its radius), the window axis sharded 4 ways, then 3 ways padded
    # with pad_to_multiple (a padded window takes the last window's table,
    # grid, center and radius, and has no frame)
    tables, w_open, w_closed, grids, cents, radii, truths = [], [], [], [], [], [], []
    for sp_i, points, window, truth, init, radius, step in fleet:
        for p in points:
            tables.append(sp_i.spline_table)
            w_open.append(sp_i.build_window(p, p + window, closed=False))
            w_closed.append(sp_i.build_window(p, p + window, closed=True))
            grids.append(presync_grid(init, radius, step))
            cents.append(init)
            radii.append(radius)
            truths.append(truth)
    margin = max(abs(c) + r for c, r in zip(cents, radii))
    _, w_open = MU.stack_problems(tables, w_open, margin)  # checks the windows are interior
    _, w_closed = MU.stack_problems(tables, w_closed, margin)
    grid_np = np.full((len(grids), max(map(len, grids))), np.inf, np.float32)
    for i, g in enumerate(grids):
        grid_np[i, : len(g)] = g
    f32 = dict(dtype=torch.float32, device=dev)
    grid_t, cent_t, rad_t = (torch.tensor(x, **f32) for x in (grid_np, cents, radii))
    truth_t = torch.tensor(truths, dtype=torch.float64, device=dev)

    def fleet_run(n):
        """(unsharded, sharded over n shards on cuda:0) delays of the
        fleet padded to a multiple of n, and the pad."""
        wo, W0 = M.pad_to_multiple(w_open, n)
        wc, _ = M.pad_to_multiple(w_closed, n)
        pad = wo.counts.shape[0] - W0

        def rep(x):
            return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])

        t = MU.stack_tables(tables + tables[-1:] * pad)
        g, c, r = rep(grid_t), rep(cent_t), rep(rad_t)
        mesh = M.make_mesh(["cuda:0"] * n)
        out = []
        for sharded in (False, True):
            gen = torch.Generator(device=dev).manual_seed(5)
            S.reset_launch_counters()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if sharded:
                _, cur = M.sharded_presync(t, wo, g, gen, mesh, centers=c)
            else:
                _, cur = B.batched_presync(t, wo, g, gen, centers=c)
            for _ in range(4):
                cur = (M.sharded_sync(t, wc, cur, c, r, gen, mesh) if sharded
                       else B.batched_sync(t, wc, cur, c, r, gen)).delay
            torch.cuda.synchronize()
            out.append((cur, time.perf_counter() - t1, dict(S.LAUNCHES)))
            collect_shapes(seen, f"20 fleet: {n} shards" if sharded else "20 fleet: unsharded", S)
        return out, W0, pad

    for n in (4, 3):
        ((ref, t_ref, _), (got, wall, launches)), W0, pad = fleet_run(n)
        err = float((got[:W0].double() - truth_t).abs().max()) * 1e3
        d = float((got - ref).abs().max()) * 1e3
        print(f"# fleet ({W0} windows of {len(fleet)} clips, padded by {pad}) over {n} shards on "
              f"cuda:0: {wall:.3f} s (unsharded {t_ref:.3f} s), launches {launches}; vs "
              f"unsharded bit-equal {bool(torch.equal(got, ref))} (max {d:.6f} ms); max offset "
              f"error {err:.4f} ms ({card})", flush=True)
        check(err <= OFFSET_TOL_MS, f"fleet over {n} shards: offset error {err:.4f} ms")
        check(d <= MESH_AGREE_MS, f"fleet over {n} shards: {d:.6f} ms from unsharded")
        check(launches["score_quartile_batched"] > 0, f"fleet over {n} shards: K2 not launched")


def hybrid_phase(np, torch, dev, card, ST, TR, seen) -> None:
    """Phase 21: phase 6's tracker input through lk_track_video_chunked
    with hybrid=False and hybrid=True (K3 counters zeroed just before
    each and read just after); ms per pair of each, median of 3 after
    the counted run; and, to find a GEMM or sum whose order changes
    with the batch, the hoisted pyramid levels and level-0 templates
    against those of the first block."""
    H, Wd = TRACK_HW
    Hp, Wp = TR._stored_dims(H, Wd, "fine")
    n_frames = HYBRID_FRAMES
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = torch.randint(0, 256, (n_frames, Hp, Wp), dtype=torch.uint8, device=dev,
                          generator=gen)

    def track(hybrid):
        return TR.lk_track_video_chunked(noise, chunk=CHUNK, grid_step=GRID_STEP,
                                         logical_hw=TRACK_HW, hybrid=hybrid)

    out, info = {}, {}
    for hybrid in (False, True):
        ST.reset_launch_counters()
        out[hybrid] = track(hybrid)
        torch.cuda.synchronize()
        launches = dict(ST.LAUNCHES)
        shapes = sorted(ST.LAUNCH_SHAPES["gather_strips"])
        collect_shapes(seen, f"21 hybrid={hybrid}", ST)
        ms = 1e3 * wall_s(lambda: track(hybrid), torch) / (n_frames - 1)
        info[hybrid] = (launches, shapes, ms)
        print(f"# tracker hybrid={hybrid} ({n_frames} frames {Wd}x{H}, chunks of {CHUNK}): "
              f"{ms:.4f} ms/pair, K3 launches {launches['gather_strips']}, shapes (T, Hp, Wp, "
              f"B, N, dtype) {shapes} ({card})", flush=True)
        check(launches["gather_strips"] > 0, f"hybrid={hybrid}: K3 was not launched")
    a, b = out[False], out[True]
    diff = float((a - b).abs().max())
    print(f"# hybrid vs block tracks: bit-identical {bool(torch.equal(a, b))}, max "
          f"{diff:.3e} px", flush=True)
    check(tuple(b.shape) == tuple(a.shape) and bool(torch.isfinite(b).all()),
          "hybrid: bad tracks")
    check(diff <= TRACK_AGREE_PX, f"hybrid and block tracks differ by {diff:.3e} px")
    check(any(sh[0] == n_frames and sh[3] == CHUNK for sh in info[True][1]),
          "hybrid: K3 never read the whole clip")

    levels = TR.auto_levels(H, Wd)
    need, plan, _ = TR._level_plan(levels, TR.LK_ITERS, TR.LK_RADIUS)
    small = [lvl for lvl in need if lvl > 0]
    whole = TR.build_pyramid_sparse(noise, levels, small, TRACK_HW, plan)
    block = TR.build_pyramid_sparse(noise[:CHUNK + 1], levels, small, TRACK_HW, plan)
    levels_eq = {lvl: bool(torch.equal(whole[lvl][:CHUNK + 1], block[lvl])) for lvl in small}
    pts = TR.grid_points(Wd, H, GRID_STEP)
    r0 = TR._fine_plan(levels, TR.LK_ITERS, TR.LK_RADIUS)[-1][3]
    t_whole = TR._lk_templates(noise, pts, r0)
    t_block = TR._lk_templates(noise[:CHUNK], pts, r0)
    tmpl_eq = {k: bool(torch.equal(t_whole[k][:CHUNK], t_block[k])) for k in t_block}
    print(f"# hoisted ({n_frames} frames) vs first block: pyramid level equal {levels_eq}, "
          f"level-0 templates equal {tmpl_eq}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description="Drive the PyTorch + CUDA port on one card.")
    ap.add_argument("--parent-csrc", metavar="DIR",
                    help="a directory of earlier sources: its gather_strips.cu (the "
                         "first K3 kernel's C interface) and copy_block.cu (the first E7 "
                         "kernel's) are timed beside the kernels; a source missing there or "
                         "equal to this checkout's is skipped")
    args = ap.parse_args()
    try:
        import torch
    except ImportError as e:
        fail(f"PyTorch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("CUDA is not available; this script runs only on a CUDA card")
    try:
        import numpy as np

        from rssync_tpu_torch import create_sync_problem
        from rssync_tpu_torch.analysis.metrics import sync_rmse
        from rssync_tpu_torch.core import ransac as R
        from rssync_tpu_torch.core.presync import presync_grid
        from rssync_tpu_torch.parallel import batch as B
        from rssync_tpu_torch.parallel import mesh as M
        from rssync_tpu_torch.parallel import multi as MU
        from rssync_tpu_torch.core.problem import compute_problem
        from rssync_tpu_torch.experiments import (
            mb_extract,
            mb_extract2,
            pallas_patch,
            r3_dma,
            r4_i16score,
            r4_slice2,
            r4_u8pass,
            r4_u8pass2,
        )
        from rssync_tpu_torch.experiments._harness import FULL, make_frames
        from rssync_tpu_torch.frontend import telemetry as TEL
        from rssync_tpu_torch.frontend import tracking as TR
        from rssync_tpu_torch.ops import _kernels
        from rssync_tpu_torch.ops import blockcopy as BC
        from rssync_tpu_torch.ops import convert as CV
        from rssync_tpu_torch.ops import patches as PT
        from rssync_tpu_torch.ops import score as S
        from rssync_tpu_torch.ops import strips as ST
        from rssync_tpu_torch.testing import profile_strips as PS
        from rssync_tpu_torch.ops.spline import eval_spline_packed
        from rssync_tpu_torch.pipeline.recipe import (
            SYNC_PASSES,
            fill_gyro,
            make_syncpoints,
            presync_stage,
            run_batched,
            set_gyro_rates,
            sync_stage,
            syncpoint_windows,
            window_pair_ranges,
        )
        from rssync_tpu_torch.testing.engine_problem import (
            OPERATING_POINT,
            PRESYNC_RADIUS_MS,
            PRESYNC_STEP_MS,
            make_engine_problem,
        )
        from rssync_tpu_torch.testing import bench as BENCH
        from rssync_tpu_torch.testing import golden as GD
        from rssync_tpu_torch.pipeline import __main__ as CLI
        from rssync_tpu_torch.pipeline import guess_orient as GO
        from rssync_tpu_torch.pipeline import recipe as RC
        from rssync_tpu_torch.testing.synthvideo import make_clip, write_clip_files, write_gcsv
        from rssync_tpu_torch.utils.timing import Timings, recording
        from rssync_tpu_torch.testing.texture_scene import render_scene, tracking_error
        from rssync_tpu_torch.utils import track_cache

        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from gpmf_fixture import write_gpmf_mp4
        from synthetic import make_scene
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")
    dev = torch.device("cuda")
    radius_s = PRESYNC_RADIUS_MS / 1000
    t_start = time.perf_counter()

    def phase(name, t0):
        print(f"# phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)

    # -- phase 1: the card and the build ------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)
    make = subprocess.Popen(["make", "-C", os.path.join(ROOT, "native", "gpmf")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _kernels.load()
    print(f"# kernel build+load: {time.perf_counter() - t0:.2f} s "
          f"(nvcc, one process per source, {_kernels.build_seconds:.2f} s)", flush=True)
    # an earlier K3 and E7, timed beside the kernels wherever they are
    # compared; a source equal to this checkout's has nothing to compare
    def earlier(name, build):
        src = Path(args.parent_csrc) / name
        if not src.exists() or src.read_bytes() == (_kernels.CSRC / name).read_bytes():
            return None
        lib = build(src)
        print(f"# parent {name} from {args.parent_csrc} built: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        return lib

    parent = copy_parent = None
    if args.parent_csrc:
        parent = earlier("gather_strips.cu", PS.build_parent)
        copy_parent = earlier("copy_block.cu", PS.build_parent_copy)
    make_log = make.communicate(timeout=300)[0]
    check(make.returncode == 0, f"make -C native/gpmf failed:\n{make_log}")
    print(f"# native telemetry parser built: {time.perf_counter() - t0:.2f} s", flush=True)

    # -- phase 2: the engine's main path at the operating point -------------
    t0 = time.perf_counter()
    prob = make_engine_problem(**OPERATING_POINT)
    t_gen = time.perf_counter() - t0
    t1 = time.perf_counter()
    sp = create_sync_problem(seed=0)
    prob.feed(sp)
    window = prob.sync_window
    W = len(prob.syncpoints)
    truth = prob.true_delay
    print(f"# host: problem generation {t_gen:.2f} s, SyncProblem intake "
          f"{time.perf_counter() - t1:.2f} s, {W} windows", flush=True)

    S.reset_launch_counters()
    t1 = time.perf_counter()
    delays_ms = run_batched(sp, prob.syncpoints, window, 0.0, True,
                            PRESYNC_RADIUS_MS, PRESYNC_STEP_MS)
    first = prob.syncpoints[0]
    _, d = sp.pre_sync(0.0, first, first + window, PRESYNC_STEP_MS / 1000, radius_s)
    for _ in range(SYNC_PASSES):
        cost, d = sp.sync(d, first, first + window, 0.0, radius_s)
    grid, costs = sp.debug_pre_sync(0.0, first, first + window, radius_s, 200)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t1
    engine_kernels = ("score_quartile", "score_quartile_batched")
    launches = {k: S.LAUNCHES[k] for k in engine_kernels}
    shapes = {k: sorted(S.LAUNCH_SHAPES[k]) for k in engine_kernels}
    print(f"# engine main path (run_batched + one window's pre_sync/4x sync/debug_pre_sync, "
          f"builds windows): {t_main:.2f} s, launches {launches}, "
          f"launch shapes (B, F, N, I) {shapes}", flush=True)
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the engine's main path")

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
    phase("2 (engine main path)", t0)

    # -- phase 3: K1/K2 against the plain version at every shape the engine's
    # main path launched them at --------------------------------------------
    t0 = time.perf_counter()
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    compared = {
        name: [compare_score(np, torch, S, PS, name, shape, dev, seed, flush)
               for seed, shape in enumerate(shapes[name])]
        for name in shapes
    }
    del flush  # phase 5 reads the peak device memory
    phase("3 (K1/K2 vs plain)", t0)

    # -- phase 4: a small engine problem on the card and on the CPU ---------
    t0 = time.perf_counter()
    small = make_engine_problem(seed=3, duration=4.0, fps=30.0, n_features=40,
                                sync_window=12, syncpoint_distance=30, true_delay=-0.021)
    per_device = []
    for where in (dev, torch.device("cpu")):
        p = create_sync_problem(seed=0, device=where)
        small.feed(p)
        per_device.append(run_batched(p, small.syncpoints, 12, 0.0, True, 200.0, 2.0))
    agree_ms = float(np.abs(np.subtract(*per_device)).max())
    print(f"# small engine problem: card vs CPU delays agree to {agree_ms:.6f} ms", flush=True)
    check(agree_ms <= CPU_AGREE_MS, f"card and CPU disagree by {agree_ms:.4f} ms")
    per_device = []
    for where in (dev, torch.device("cpu")):
        p = create_sync_problem(seed=0, device=where)
        small.feed(p)
        ow, cw = syncpoint_windows(p, small.syncpoints, 12)
        best = presync_stage(p, ow, 0.0, 200.0, 2.0)
        res = sync_stage(p, cw, best, 0.0, 0.2, motion_opt="lbfgs")[-1]
        per_device.append(1000 * res.delay.double().cpu().numpy())
    agree_ms = float(np.abs(np.subtract(*per_device)).max())
    small_err = float(np.abs(per_device[0] - 1000 * small.true_delay).max())
    print(f"# small engine problem, L-BFGS Sync: card vs CPU delays agree to {agree_ms:.6f} ms; "
          f"card error {small_err:.4f} ms", flush=True)
    check(agree_ms <= CPU_AGREE_MS, f"L-BFGS: card and CPU disagree by {agree_ms:.4f} ms")
    check(small_err <= OFFSET_TOL_MS, f"L-BFGS small problem offset error {small_err:.4f} ms")
    phase("4 (engine card vs CPU)", t0)

    # -- phase 5: engine stage times at the operating point -----------------
    t0 = time.perf_counter()
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

    # the L-BFGS Sync at full width, after the same PreSync
    S.reset_launch_counters()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with recording() as rec:
        lbfgs = sync_stage(sp, closed_wins, out["presync"], 0.0, radius_s, motion_opt="lbfgs")
        torch.cuda.synchronize()
    t_lbfgs = time.perf_counter() - t1
    lbfgs_launches = dict(S.LAUNCHES)
    lbfgs_counts = {k: rec.counted(f"lbfgs.{k}") for k in ("trips", "evaluations")}
    lbfgs_err_ms = float((lbfgs[-1].delay.double() - truth).abs().max()) * 1000
    lbfgs_iters = [int(r.iterations.max()) for r in lbfgs]
    lbfgs_trips = [int(r.motion_iterations.max()) for r in lbfgs]
    irls_rounds = [int(r.motion_iterations.max()) for r in out["sync"]]
    lbfgs_vs_irls = float((lbfgs[-1].delay - out["sync"][-1].delay).abs().max()) * 1000
    print(f"# Sync(4x) motion_opt=lbfgs over {W} windows: {t_lbfgs:.4f} s (one run), outer "
          f"iterations per pass {lbfgs_iters}, L-BFGS iterations per pass (most of any window) "
          f"{lbfgs_trips}, batched L-BFGS loop {lbfgs_counts['trips']} trips with "
          f"{lbfgs_counts['evaluations']} value-and-gradient evaluations "
          f"({1e3 * t_lbfgs / max(lbfgs_counts['trips'], 1):.3f} ms a trip), launches "
          f"{lbfgs_launches}, max offset err {lbfgs_err_ms:.4f} ms; "
          f"IRLS beside it: {t_sync:.4f} s (median of 3), outer iterations {iters}, IRLS "
          f"rounds {irls_rounds}, max offset err {bench_err_ms:.4f} ms; L-BFGS vs IRLS delays "
          f"{lbfgs_vs_irls:.4f} ms apart ({card})", flush=True)
    check(lbfgs_launches["score_quartile_batched"] > 0, "L-BFGS Sync did not launch K2")
    check(lbfgs_err_ms <= OFFSET_TOL_MS, f"L-BFGS Sync offset error {lbfgs_err_ms:.4f} ms")
    del sp, open_wins, closed_wins, out, lbfgs
    phase("5 (engine stage times, IRLS and L-BFGS)", t0)

    # -- phase 6: the tracker at its operating point ------------------------
    t0 = time.perf_counter()
    H, Wd = TRACK_HW
    levels = TR.auto_levels(H, Wd)
    Hp, Wp = TR._stored_dims(H, Wd, "fine")
    n_frames = 15 * CHUNK + 1
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = torch.randint(0, 256, (n_frames, Hp, Wp), dtype=torch.uint8, device=dev,
                          generator=gen)

    def track_noise():
        return TR.lk_track_video_chunked(noise, chunk=CHUNK, grid_step=GRID_STEP,
                                         logical_hw=TRACK_HW)

    ST.reset_launch_counters()
    tracked = track_noise()
    torch.cuda.synchronize()
    k3_launches = dict(ST.LAUNCHES)
    k3_shapes = sorted(ST.LAUNCH_SHAPES["gather_strips"])
    n_pts = len(TR.grid_points(Wd, H, GRID_STEP))
    print(f"# tracker main path ({n_frames} frames {Wd}x{H} stored {Wp}x{Hp}, {levels} levels, "
          f"plan {TR._fine_plan(levels, TR.LK_ITERS, TR.LK_RADIUS)}, {n_pts} points, chunks of "
          f"{CHUNK} pairs): launches {k3_launches}, launch shapes (T, Hp, Wp, B, N, dtype) "
          f"{k3_shapes}", flush=True)
    check(k3_launches["gather_strips"] > 0, "kernel gather_strips was not launched on the "
          "tracker's main path")
    check(tuple(tracked.shape) == (n_frames - 1, n_pts, 2)
          and bool(torch.isfinite(tracked).all()), "tracker: bad output on noise frames")
    t_track = wall_s(track_noise, torch)
    ms_per_pair = 1e3 * t_track / (n_frames - 1)
    print(f"# tracker: {ms_per_pair:.4f} ms/pair ({t_track:.4f} s for {n_frames - 1} pairs, "
          f"median of 3 after a warm-up; {card})", flush=True)
    del noise
    phase("6 (tracker operating point)", t0)

    # -- phase 7: tracking accuracy on a textured scene ---------------------
    t0 = time.perf_counter()
    tex, affines = render_scene(seed=5, n_frames=9, height=H, width=Wd)
    t_render = time.perf_counter() - t0
    tex_t = torch.as_tensor(TR.pad_frames_host(tex)).to(dev)
    tracked = TR.lk_track_video_chunked(tex_t, chunk=8, grid_step=GRID_STEP,
                                        logical_hw=TRACK_HW).cpu().numpy()
    pts = TR.grid_points(Wd, H, GRID_STEP)
    med_px, p95_px = tracking_error(tracked, pts, affines, Wd, H)
    print(f"# textured scene: host render {t_render:.2f} s (9 frames), tracking error "
          f"median {med_px:.4f} px, p95 {p95_px:.4f} px over {len(affines) - 1} pairs", flush=True)
    check(med_px <= TEX_MED_PX and p95_px <= TEX_P95_PX,
          f"textured tracking error {med_px:.4f} / {p95_px:.4f} px")
    del tex_t
    phase("7 (textured accuracy)", t0)

    # -- phase 8: rendered frames -> tracks -> sync at full width ----------
    t0 = time.perf_counter()
    clip = make_clip(seed=0, true_delay=0.0423, fps=60.0, n_frames=480, width=Wd,
                     height=H, gyro_rate=200.0, readout=0.01111, pad=2.0)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    sync_window = 60
    syncpoints = make_syncpoints({"sync_window": sync_window, "syncpoint_distance": 120},
                                 0, clip.n_frames - 1)
    check(syncpoints == [0, 120, 240, 360], f"unexpected syncpoints {syncpoints}")
    S.reset_launch_counters()
    ST.reset_launch_counters()
    t1 = time.perf_counter()
    sp = create_sync_problem(seed=0)
    set_gyro_rates(sp, clip.gyro_ts, clip.gyro_rates, clip.orient)
    TR.track_clip(sp, clip.lens, clip.frames, clip.frame_ts,
                  window_pair_ranges(syncpoints, sync_window))
    torch.cuda.synchronize()
    t_track = time.perf_counter() - t1
    t1 = time.perf_counter()
    e2e_ms = np.asarray(run_batched(sp, syncpoints, sync_window, 1.0, True,
                                    PRESYNC_RADIUS_MS, PRESYNC_STEP_MS))
    t_sync = time.perf_counter() - t1
    e2e_err = np.abs(e2e_ms - 1000 * clip.true_delay)
    print(f"# end to end {Wd}x{H}: render {clip.n_frames} frames on the card {t_render:.2f} s, "
          f"gyro intake + track {len(syncpoints)} windows ({len(syncpoints) * (sync_window + 1)} "
          f"pairs) + emit {t_track:.2f} s, run_batched {t_sync:.2f} s; launches "
          f"{dict(S.LAUNCHES)} {dict(ST.LAUNCHES)}; delays {e2e_ms.round(4).tolist()} ms, "
          f"truth {1000 * clip.true_delay:.4f} ms, errors {e2e_err.round(4).tolist()} ms",
          flush=True)
    check(ST.LAUNCHES["gather_strips"] > 0 and S.LAUNCHES["score_quartile_batched"] > 0,
          "end to end: a kernel was not launched")
    check(bool(np.isfinite(e2e_err).all()) and e2e_err.max() <= OFFSET_TOL_MS,
          f"end to end offset error {e2e_err.max():.4f} ms")

    # the same gyro log from files, through load_gyro and fill_gyro
    with tempfile.TemporaryDirectory() as tmp:
        tracks = os.path.join(tmp, "tracks.npz")
        track_cache.save_tracks(sp, tracks)
        files = {"gcsv": os.path.join(tmp, "clip.gcsv"), "gpmf": os.path.join(tmp, "clip.mp4")}
        write_gcsv(files["gcsv"], clip.gyro_ts, clip.gyro_rates)
        # the int16 GYRO samples' SCAL: the finest the log's largest rate allows
        gpmf_scale = int(32767 // np.abs(clip.gyro_rates).max())
        write_gpmf_mp4(files["gpmf"], clip.gyro_rates, rate_hz=clip.gyro_rate,
                       scale=gpmf_scale)
        for fmt, path in files.items():
            t1 = time.perf_counter()
            native = TEL.load_gyro(path, clip.orient, prefer_native=True)
            t_native = time.perf_counter() - t1
            served = "native" if TEL._native_load(path, clip.orient) is not None else "python"
            t1 = time.perf_counter()
            python = TEL.load_gyro(path, clip.orient, prefer_native=False)
            t_python = time.perf_counter() - t1
            same = (np.array_equal(native.timestamps, python.timestamps)
                    and np.array_equal(native.gyro, python.gyro))
            p = create_sync_problem(seed=0)
            track_cache.load_tracks(p, tracks)
            fill_gyro(p, path, clip.orient)
            S.reset_launch_counters()
            t1 = time.perf_counter()
            file_ms = np.asarray(run_batched(p, syncpoints, sync_window, 1.0, True,
                                             PRESYNC_RADIUS_MS, PRESYNC_STEP_MS))
            t_file = time.perf_counter() - t1
            file_err = np.abs(file_ms - 1000 * clip.true_delay)
            file_agree = float(np.abs(file_ms - e2e_ms).max())
            print(f"# file intake {fmt} ({os.path.getsize(path)} B, {native.samples} samples"
                  + (f", SCAL {gpmf_scale}" if fmt == "gpmf" else "") + f"): load_gyro "
                  f"{1e3 * t_native:.3f} ms served by the {served} parser, Python parser "
                  f"{1e3 * t_python:.3f} ms, parsers equal {same}; run_batched "
                  f"{t_file:.2f} s, launches {dict(S.LAUNCHES)}; delays "
                  f"{file_ms.round(4).tolist()} ms, errors {file_err.round(4).tolist()} ms, "
                  f"{file_agree:.6f} ms from the in-memory intake", flush=True)
            check(served == "native", f"{fmt}: the native parser did not serve load_gyro")
            check(same, f"{fmt}: the native and Python parsers disagree")
            check(S.LAUNCHES["score_quartile_batched"] > 0, f"{fmt}: K2 was not launched")
            check(bool(np.isfinite(file_err).all()) and file_err.max() <= OFFSET_TOL_MS,
                  f"{fmt} intake offset error {file_err.max():.4f} ms")
            check(file_agree <= FILE_AGREE_MS,
                  f"{fmt} intake {file_agree:.6f} ms from the in-memory intake")
    recipe_clip, phase8_ms = clip, e2e_ms  # phase 16 syncs the same clip from files
    del clip, sp
    phase("8 (end to end at full width, in memory and from files)", t0)

    # -- phase 9: a small rendered clip on the card and on the CPU ----------
    t0 = time.perf_counter()
    clip = make_clip(seed=2, true_delay=0.0213, n_frames=26, fps=30.0, width=640,
                     height=480, pad=1.0)
    syncpoints = make_syncpoints({"sync_window": 8, "syncpoint_distance": 8}, 0, 25)
    tracks, delays = [], []
    for where in (dev, torch.device("cpu")):
        frames = clip.frames.to(where)
        tracks.append(TR.lk_track_video(frames).cpu().numpy())
        p = create_sync_problem(seed=0, device=where)
        set_gyro_rates(p, clip.gyro_ts, clip.gyro_rates, clip.orient)
        TR.track_clip(p, clip.lens, frames, clip.frame_ts, window_pair_ranges(syncpoints, 8))
        delays.append(np.asarray(run_batched(p, syncpoints, 8, 0.5, True, 80.0, 2.0)))
    track_px = float(np.abs(tracks[0] - tracks[1]).max())
    delay_agree = float(np.abs(delays[0] - delays[1]).max())
    small_err = float(np.abs(delays[0] - 1000 * clip.true_delay).max())
    print(f"# small rendered clip 640x480: card vs CPU tracks agree to {track_px:.6f} px, "
          f"delays to {delay_agree:.6f} ms; card error {small_err:.4f} ms", flush=True)
    check(track_px <= TRACK_AGREE_PX, f"card and CPU tracks differ by {track_px:.6f} px")
    check(delay_agree <= CPU_AGREE_MS, f"card and CPU delays differ by {delay_agree:.4f} ms")
    check(small_err <= OFFSET_TOL_MS, f"small clip offset error {small_err:.4f} ms")
    phase("9 (rendered clip card vs CPU)", t0)

    # -- phase 10: K3 against its plain version ------------------------------
    t0 = time.perf_counter()
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    strip_rows = [compare_strips(np, torch, ST, PS, shape, dev, seed, False, flush, parent)
                  for seed, shape in enumerate(k3_shapes)]
    # edge shapes: (shape, seed, random frame indices, every strip at the
    # last valid row and block)
    for shape, seed, random_fidx, edge in STRIP_EDGES:
        strip_rows.append(compare_strips(np, torch, ST, PS, shape, dev, seed, random_fidx,
                                         flush, parent, edge))
    phase("10 (K3 vs plain)", t0)

    # -- phase 11: the probe paths, each with its kernel's counters zeroed
    # just before and read just after ----------------------------------------
    t0 = time.perf_counter()
    probe = make_frames(dev)
    torch.cuda.synchronize()
    print(f"# probe frames {tuple(probe.shape)} u8 from a numpy seed, padded on the host: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    probe_paths = {}
    for key, harness, counters, kernel in (
            ("e5", r4_u8pass, CV, "u8_to_bf16"), ("e6", r4_u8pass2, CV, "u8_to_bf16"),
            ("e7", r4_slice2, BC, "copy_block")):
        counters.reset_launch_counters()
        result = harness.run(device=dev, frames=probe)
        torch.cuda.synchronize()
        probe_paths[key] = (counters.LAUNCHES[kernel], sorted(counters.LAUNCH_SHAPES[kernel]),
                            result)
        print(f"# {harness.__name__}: launches {dict(counters.LAUNCHES)}, launch shapes "
              f"{probe_paths[key][1]}", flush=True)
        check(probe_paths[key][0] > 0, f"kernel {kernel} was not launched on {harness.__name__}")
    conv = probe_paths["e5"][2], probe_paths["e6"][2]
    check(conv[0]["kernel_conv"]["value"] == conv[0]["conv_mat"]["value"]
          and conv[1]["kernel_conv"]["value"] == conv[1]["conv"]["value"],
          "kernel_conv disagrees with the .to(bfloat16) pass")
    sl = probe_paths["e7"][2]
    check(sl["kernel_sum"]["value"] == sl["slice_sum"]["value"],
          "kernel_sum disagrees with slice_sum")
    del probe
    S.reset_launch_counters()
    i16_run = r4_i16score.run(device=dev)
    torch.cuda.synchronize()
    e8_launches = S.LAUNCHES["score_quartile_i16"]
    e8_shapes = sorted(S.LAUNCH_SHAPES["score_quartile_i16"])
    print(f"# r4_i16score: launches {dict(S.LAUNCHES)}, E8 launch shapes {e8_shapes}; PreSync "
          f"K2 {i16_run['k2']['ms']:.4f} ms, E8 {i16_run['i16']['ms']:.4f} ms; best delays "
          f"{i16_run['i16']['delay'].tolist()[:4]}... ({card})", flush=True)
    check(e8_launches > 0, "kernel score_quartile_i16 was not launched on r4_i16score")
    check(i16_run["parity_equal"] and i16_run["identical"],
          "PreSync through E8 differs from PreSync through K2")
    phase("11 (probe paths)", t0)

    # -- phase 12: E5-E8 against their plain versions ----------------------
    t0 = time.perf_counter()
    e5_rows = [compare_convert(np, torch, CV, PS, sh, dev, 20 + i, flush)
               for i, sh in enumerate(probe_paths["e5"][1])]
    e6_rows = [compare_convert(np, torch, CV, PS, sh, dev, 30 + i, flush)
               for i, sh in enumerate(probe_paths["e6"][1])]
    e7_rows = [compare_copy(np, torch, BC, PS, sh, dev, 40 + i, flush, FULL.chunk,
                            copy_parent)
               for i, sh in enumerate(probe_paths["e7"][1])]
    compare_copy_edges(torch, BC, dev)
    sync_shape = (30, 60, 130, 200)  # batched Sync's K2 launch, E8 on no path there
    e8_rows = [compare_i16(np, torch, S, PS, sh, dev, 50 + i, flush)
               for i, sh in enumerate(e8_shapes + [sync_shape] * (sync_shape not in e8_shapes))]
    phase("12 (E5-E8 vs plain)", t0)

    # -- phase 13: the patch paths, each with its kernel's counters zeroed
    # just before and read just after ----------------------------------------
    t0 = time.perf_counter()
    p3 = mb_extract.FULL
    e3_img = mb_extract.make_image(dev)
    e3_origins = mb_extract.make_origins(dev, p3.points)
    patch_paths = {}

    def read_patch_path(key, name):
        torch.cuda.synchronize()
        patch_paths[key] = (PT.LAUNCHES["extract_patches"],
                            sorted(PT.LAUNCH_SHAPES["extract_patches"]))
        print(f"# {name}: launches {dict(PT.LAUNCHES)}, launch shapes (H, W, N, size, dtype, "
              f"per_block) {patch_paths[key][1]}", flush=True)
        check(patch_paths[key][0] > 0, f"kernel extract_patches was not launched on {name}")

    PT.reset_launch_counters()
    routes_equal = []
    for dt in (torch.uint8, torch.bfloat16, torch.float32):
        img = e3_img.to(dt)
        rows, cols, ra = pallas_patch.aligned_region(dt, p3.size)
        unmoved = torch.equal(PT.clamp_aligned(e3_origins, *img.shape, rows, cols, ra),
                              e3_origins)
        kern = pallas_patch.extract_patches(img, e3_origins, p3.size, force="kernel")
        gath = pallas_patch.extract_patches(img, e3_origins, p3.size, force="gather")
        routes_equal.append(bool(unmoved) and bool(torch.equal(kern, gath)))
    read_patch_path("e1", pallas_patch.__name__)
    print(f"# pallas_patch kernel route == gather route (u8, bf16, f32): {routes_equal}",
          flush=True)
    check(all(routes_equal), "pallas_patch: the kernel and gather routes disagree")
    del e3_img, e3_origins

    ST.reset_launch_counters()
    e2_run = r3_dma.run(device=dev)
    torch.cuda.synchronize()
    e2_launches = ST.LAUNCHES["gather_strips"]
    e2_shapes = sorted(ST.LAUNCH_SHAPES["gather_strips"])
    print(f"# r3_dma: launches {dict(ST.LAUNCHES)}, launch shapes (T, Hp, Wp, B, N, dtype) "
          f"{e2_shapes} ({card})", flush=True)
    check(e2_launches > 0, "kernel gather_strips was not launched on r3_dma")
    check(e2_run["match"], "r3_dma: the strips differ from the row-block gather")

    PT.reset_launch_counters()
    e3_run = mb_extract.run(device=dev)
    read_patch_path("e3", mb_extract.__name__)
    e3_values = {r["value"] for r in e3_run.values()}
    check(len(e3_values) == 1, f"mb_extract: the variants' sums differ {sorted(e3_values)}")

    PT.reset_launch_counters()
    e4_run = mb_extract2.run(device=dev)
    read_patch_path("e4", mb_extract2.__name__)
    e4_same = {n: r["value"] for n, r in e4_run.items() if r["patches"] == (p3.points, p3.size)}
    print(f"# mb_extract2: the {len(e4_same)} variants of the {p3.points} x {p3.size} x "
          f"{p3.size} set sum to {sorted(set(e4_same.values()))} ({card})", flush=True)
    check(len(e4_same) == 5 and len(set(e4_same.values())) == 1,
          f"mb_extract2: the variants' sums differ {e4_same}")
    check(all(e4_run[f"kernel_nbuf{b}"]["correct"] for b in mb_extract2.NBUF),
          "mb_extract2: E4's patch check failed")
    phase("13 (patch paths)", t0)

    # -- phase 14: extract_patches and K3 against their plain versions at
    # the shapes the patch paths launched them at ----------------------------
    t0 = time.perf_counter()
    patch_shapes = sorted(set().union(*(set(v[1]) for v in patch_paths.values())))
    patch_rows = {sh: compare_patches(np, torch, PT, PS, sh, dev, 60 + i, flush)
                  for i, sh in enumerate(patch_shapes)}
    odd_row = compare_patches(np, torch, PT, PS, (37, 131, 9, 7, "torch.bfloat16", 3), dev, 69,
                             flush)
    instances = {(isz, size, depth): patch_kernel_attrs(isz, size, depth)
                 for isz in (1, 2, 4) for size in (PT.ROW_SIZE, 7) for depth in (1, 2, 4, 8)}
    print(f"# extract_patches instances (itemsize, size, depth): registers, local bytes a "
          f"thread {[(k, v['regs'], v['local_bytes']) for k, v in instances.items()]}",
          flush=True)
    e2_rows = [compare_strips(np, torch, ST, PS, sh, dev, 70 + i, False, flush, parent)
               for i, sh in enumerate(e2_shapes)]
    phase("14 (patch kernels vs plain)", t0)

    # -- phase 15: the reference engine's golden data on the card -----------
    t0 = time.perf_counter()
    golden = np.load(GD.GOLDEN)
    scenes = {name: make_scene(**cfg) for name, cfg in GD.SCENES.items()}
    t_scenes = time.perf_counter() - t0
    S.reset_launch_counters()
    for name, scene in scenes.items():
        table, win = GD.scene_problem(name, scene, golden, dev)
        F = GD.SCENES[name]["n_frames"]
        p_err = 0.0
        for d in GD.PROBE_DELAYS:
            P = compute_problem(table, win, torch.tensor(d, device=dev)).permute(1, 2, 0).cpu()
            for f in (0, F // 2, F - 2):
                ref = golden[f"{name}/P/f{f}/d{d}"]
                p_err = max(p_err, float(np.abs(P[f, : ref.shape[0]].numpy() - ref).max()))
        ts = golden[f"{name}/spline/ts"]
        vals = eval_spline_packed(
            table.coeffs, torch.tensor(np.floor(ts), dtype=torch.int32, device=dev),
            torch.tensor(ts - np.floor(ts), dtype=torch.float32, device=dev)).T.cpu().numpy()
        spline_err = float(np.abs(vals - golden[f"{name}/spline/vals"]).max())
        start = float(golden[f"{name}/presync"][1])
        irls = float(GD.sync_passes(table, win, start, "irls")[-1].delay)
        irls_ref = abs(irls - golden[f"{name}/sync_delays"][-1])
        irls_truth = abs(irls - GD.SCENES[name]["true_delay"])
        traj_err, it_off = 0.0, 0
        for k, res in enumerate(GD.sync_passes(table, win, start, "lbfgs")):
            ref = golden[f"{name}/sync_traj/p{k}"]
            n = int(res.iterations)
            it_off = max(it_off, abs(n - len(ref)))
            m = min(n, len(ref))
            if m:
                traj_err = max(
                    traj_err,
                    float(np.abs(res.trace_delay[:m].cpu().numpy() - ref[:m, 0]).max()),
                    float(np.abs(res.trace_step[:m].abs().cpu().numpy() - ref[:m, 1]).max()))
        atol = GD.trajectory_atol(name)
        print(f"# golden {name} on the card: P {p_err:.3e} (<= {GD.P_ATOL:g}), spline "
              f"{spline_err:.3e} (<= {GD.SPLINE_ATOL:g}), IRLS Sync {irls_ref:.3e} s from the "
              f"reference (<= {GD.SYNC_REF_TOL_S:g}) and {irls_truth:.3e} s from the truth (<= "
              f"{GD.SYNC_TRUTH_TOL_S:g}), L-BFGS trajectories {traj_err:.3e} (<= {atol:g}), "
              f"iteration counts off by <= {it_off} (<= 1)", flush=True)
        check(p_err <= GD.P_ATOL and spline_err <= GD.SPLINE_ATOL
              and irls_ref < GD.SYNC_REF_TOL_S and irls_truth < GD.SYNC_TRUTH_TOL_S
              and traj_err <= atol and it_off <= 1, f"golden scene {name} out of tolerance")
    torch.cuda.synchronize()
    print(f"# golden scenes: make_scene on the host {t_scenes:.2f} s; launches "
          f"{dict(S.LAUNCHES)}", flush=True)
    check(S.LAUNCHES["score_quartile"] > 0, "the golden Sync passes did not launch K1")
    phase("15 (golden data on the card)", t0)

    # -- phase 16: the recipe path at full width ---------------------------
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="rssync_recipe_")
    seen = {}  # kernel -> launch shape -> the phase 16-17 runs that launched it
    try:
        recipe_launches, recipe, cache = recipe_phase(
            np, torch, dev, card, recipe_clip, phase8_ms, S, ST, TR, RC, CLI, Timings,
            write_clip_files, PRESYNC_RADIUS_MS, PRESYNC_STEP_MS, tmp, seen)
        phase("16 (the recipe path: run_recipe batched and sequential, the CLI, track_frames)",
              t0)

        # -- phase 17: guess-orient and multi-clip ----------------------------
        t0 = time.perf_counter()
        fleet_recipes = guess_multi_phase(np, torch, card, recipe_clip, recipe, cache, S, ST,
                                          RC, GO, make_clip, write_clip_files, tmp, seen)
        # phase 20's fleet: both clips' problems from phase 17's track cache
        fleet = []
        for i, (r, c) in enumerate(fleet_recipes):
            sp_i, fs, fe = RC._prepare_problem(r, "lk", i, cache, Timings(), False, device=dev)
            inp = r["input"]
            fleet.append((sp_i, make_syncpoints(r["params"], fs, fe),
                          int(r["params"]["sync_window"]), c.true_delay,
                          float(inp["initial_guess"]) / 1000,
                          float(inp["simple_presync_radius"]) / 1000,
                          float(inp["simple_presync_step"]) / 1000))
        phase("17 (guess-orient and multi-clip)", t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del recipe_clip, fleet_recipes

    # -- phase 18: K1/K2/K3 against their plain versions at every shape
    # phases 16-17 launched them at that phases 3, 10 and 14 did not cover
    t0 = time.perf_counter()
    covered = {"score_quartile": set(shapes["score_quartile"]),
               "score_quartile_batched": set(shapes["score_quartile_batched"]),
               "gather_strips": set(k3_shapes) | set(e2_shapes)}
    recipe_rows = compare_new_shapes(np, torch, S, ST, PS, dev, seen, covered, 200,
                                     "phases 16-17", parent)
    phase("18 (K1/K2/K3 vs plain at the recipe paths' shapes)", t0)

    # -- phase 19: the long-term drift run at full size ---------------------
    t0 = time.perf_counter()
    seen = {}  # kernel -> launch shape -> the phase 19-21 runs that launched it
    longterm_phase(np, torch, dev, card, S, R, B, make_engine_problem, compute_problem,
                   sync_rmse, seen)
    phase("19 (long-term drift, single-frame guessers)", t0)

    # -- phase 20: the window mesh ------------------------------------------
    t0 = time.perf_counter()
    mesh_phase(np, torch, dev, card, S, B, M, MU, create_sync_problem, prob, syncpoint_windows,
               presync_grid, fleet, radius_s, PRESYNC_STEP_MS / 1000, seen)
    del fleet
    phase("20 (the window mesh, batched_sync_pipeline, the sharded fleet)", t0)

    # -- phase 21: the hybrid tracker ---------------------------------------
    t0 = time.perf_counter()
    hybrid_phase(np, torch, dev, card, ST, TR, seen)
    phase("21 (hybrid vs block tracker)", t0)

    # -- phase 22: K1/K2/K3 against their plain versions at every shape
    # phases 19-21 launched them at that no earlier phase compared
    t0 = time.perf_counter()
    new_rows = compare_new_shapes(np, torch, S, ST, PS, dev, seen, covered, 300,
                                  "phases 19-21", parent)
    phase("22 (K1/K2/K3 vs plain at the shapes of phases 19-21)", t0)

    # -- phase 24 (before phase 23, whose profiler session comes last):
    # bench.py's workload through the port's bench module ------------------
    t0 = time.perf_counter()
    S.reset_launch_counters()
    ST.reset_launch_counters()
    bench = BENCH.run(device=dev)
    bench_kernels = bench["extras"]["kernels"]
    bench_launches = {name: bench_kernels[name]["launches"] if name in bench_kernels else 0
                      for name in ("score_quartile", "score_quartile_batched", "gather_strips")}
    seen = {}
    collect_shapes(seen, "24 bench", S, ST)
    print(f"# bench: {json.dumps(bench)}", flush=True)
    ex = bench["extras"]
    check(ex["failed"] == [], f"bench: checks failed {ex['failed']}")
    check(ex["offset_err_ms"] <= OFFSET_TOL_MS, f"bench offset error {ex['offset_err_ms']:.4f} ms")
    check(ex["onvideo_track_med_px"] <= TEX_MED_PX and ex["onvideo_track_p95_px"] <= TEX_P95_PX,
          f"bench on-video error {ex['onvideo_track_med_px']:.4f} / "
          f"{ex['onvideo_track_p95_px']:.4f} px")
    check(all(k["bit_equal"] for k in bench_kernels.values()),
          "bench: a kernel differs from its plain version at a launch shape")
    check(bench_launches["score_quartile_batched"] > 0 and bench_launches["gather_strips"] > 0,
          f"bench: K2 or K3 was not launched {bench_launches}")
    bench_rows = compare_new_shapes(np, torch, S, ST, PS, dev, seen, covered, 400, "phase 24",
                                    parent)
    phase("24 (bench.py's workload)", t0)

    # -- phase 23: K3's profiler durations at every shape compared ---------
    t0 = time.perf_counter()
    profile_strips_rows(torch, ST, PS, dev, strip_rows + e2_rows + recipe_rows["gather_strips"]
                        + new_rows["gather_strips"] + bench_rows["gather_strips"], parent, card)
    profile_copy_rows(torch, BC, PS, dev, e7_rows, copy_parent, card)
    phase("23 (K3 and E7 profiler durations)", t0)

    csrc = "rssync_tpu_torch/csrc/"
    h = "rssync_tpu_torch.experiments."
    engine, tracker = "engine (run_batched + SyncProblem)", "tracker (lk_track_video_chunked)"
    patch_src = csrc + "extract_patches.cu"

    def patch_rows_of(key):
        return [patch_rows[sh] for sh in patch_paths[key][1]]

    # (name, TPU kernel, source, path, launches on it, rows of its shapes, all rows)
    entries = [
        ("score_quartile", "rssync_tpu/ops/pallas_score.py:139", csrc + "score_quartile.cu",
         engine, launches["score_quartile"], compared["score_quartile"],
         compared["score_quartile"] + recipe_rows["score_quartile"] + new_rows["score_quartile"]
         + bench_rows["score_quartile"]),
        ("score_quartile_batched", "rssync_tpu/ops/pallas_score.py:230",
         csrc + "score_quartile.cu", engine, launches["score_quartile_batched"],
         compared["score_quartile_batched"],
         compared["score_quartile_batched"] + recipe_rows["score_quartile_batched"]
         + new_rows["score_quartile_batched"] + bench_rows["score_quartile_batched"]),
        ("gather_strips", "rssync_tpu/frontend/tracking.py:434", csrc + "gather_strips.cu",
         tracker, k3_launches["gather_strips"], strip_rows[: len(k3_shapes)],
         strip_rows + recipe_rows["gather_strips"] + new_rows["gather_strips"]
         + bench_rows["gather_strips"]),
        ("u8_to_bf16", "experiments/r4_u8pass.py:54", csrc + "convert_u8.cu", h + "r4_u8pass",
         probe_paths["e5"][0], e5_rows, e5_rows),
        ("u8_to_bf16", "experiments/r4_u8pass2.py:61", csrc + "convert_u8.cu",
         h + "r4_u8pass2", probe_paths["e6"][0], e6_rows, e6_rows),
        ("copy_block", "experiments/r4_slice2.py:65", csrc + "copy_block.cu", h + "r4_slice2",
         probe_paths["e7"][0], e7_rows, e7_rows),
        ("score_quartile_i16", "experiments/r4_i16score.py:86", csrc + "score_quartile.cu",
         h + "r4_i16score", e8_launches, e8_rows[: len(e8_shapes)], e8_rows),
        ("extract_patches", "experiments/pallas_patch.py:100", patch_src, h + "pallas_patch",
         patch_paths["e1"][0], patch_rows_of("e1"), patch_rows_of("e1") + [odd_row]),
        ("gather_strips", "experiments/r3_dma.py:66", csrc + "gather_strips.cu", h + "r3_dma",
         e2_launches, e2_rows, e2_rows),
        ("extract_patches", "experiments/mb_extract.py:164", patch_src, h + "mb_extract",
         patch_paths["e3"][0], patch_rows_of("e3"), patch_rows_of("e3")),
        ("extract_patches", "experiments/mb_extract2.py:93", patch_src, h + "mb_extract2",
         patch_paths["e4"][0], patch_rows_of("e4"), patch_rows_of("e4")),
    ]
    # the TPU kernels whose port was redesigned for Hopper after its first
    # version (PERF.md §6 names the change that did it)
    redesigned = {
        "rssync_tpu/ops/pallas_score.py:139", "rssync_tpu/ops/pallas_score.py:230",
        "rssync_tpu/frontend/tracking.py:434", "experiments/r4_slice2.py:65",
        "experiments/r4_i16score.py:86", "experiments/pallas_patch.py:100",
        "experiments/r3_dma.py:66", "experiments/mb_extract.py:164",
        "experiments/mb_extract2.py:93",
    }
    stale = redesigned - {e[1] for e in entries}
    check(not stale, f"redesigned kernels that no entry replaces: {sorted(stale)}")
    kernels = []
    for name, replaces, source, path, n, main_rows, rows in entries:
        # the times stated are those of the main path's heaviest launch shape
        heavy = max(main_rows, key=lambda r: r["bound_ms"])
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, path=path,
            state="ported; redesigned" if replaces in redesigned else "ported",
            launches=n, max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=heavy["ms"], plain_ms=heavy["plain_ms"], bound_ms=heavy["bound_ms"],
            bound_by=heavy["bound_by"], library_ms=heavy["library_ms"], shapes=rows,
        ))
        if path in (engine, tracker):
            # launches on the recipe path (phase 16 (a), counters zeroed
            # just before run_recipe and read just after)
            kernels[-1]["recipe_launches"] = recipe_launches[name]
            # launches on phase 24's bench run (counters zeroed just before
            # its stages and read after each)
            kernels[-1]["bench_launches"] = bench_launches[name]
    print(f"# total {time.perf_counter() - t_start:.2f} s ({card})", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
