"""What the probe harnesses share: the tracker's operating point, its
frames, CUDA-event timing and the report lines."""

from __future__ import annotations

import statistics
import subprocess
import sys
from dataclasses import dataclass

import numpy as np
import torch

from rssync_tpu_torch.frontend.tracking import pad_frames_host

#: pyramid depth at 2704x2028 (auto_levels), as the experiments fix it
LEVELS = 8


@dataclass(frozen=True)
class Point:
    """Frames of height x width, `seg` pairs tracked in chunks of `chunk`."""

    height: int
    width: int
    seg: int
    chunk: int


#: the experiments' operating point: 241 frames of 2704x2028, 16-pair chunks
FULL = Point(2028, 2704, 240, 16)
#: the tests' shape (stored 64 x 256)
SMALL = Point(40, 200, 4, 2)


def point(small: bool) -> Point:
    return SMALL if small else FULL


def make_frames(device, small: bool = False, seed: int = 0) -> torch.Tensor:
    """The experiments' frames: seg + 1 uniform u8 frames from a numpy
    seed, stored with the level-0 padding of pad_frames_host (2816x2056
    at the operating point), on `device`."""
    p = point(small)
    frames = np.random.default_rng(seed).integers(
        0, 255, (p.seg + 1, p.height, p.width), np.uint8)
    return torch.from_numpy(pad_frames_host(frames, LEVELS)).to(device)


def timed(fn, device: torch.device, reps: int = 5):
    """(fn's first result, median CUDA-event ms of `reps` more calls).
    On the CPU fn runs once and the time is None: a CPU run times
    nothing."""
    out = fn()
    if device.type != "cuda":
        return out, None
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end))
    return out, statistics.median(times)


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    that this run is on the CPU and untimed."""
    if device.type != "cuda":
        return "# device: cpu (plain versions, not timed)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return f"# device: {torch.cuda.get_device_name(device)} ({smi.stdout.strip()})"


def line(name: str, ms: float | None, n_bytes: int | None, pairs: int) -> str:
    """One report line: ms, GB/s over `n_bytes` (the bytes the variant
    must move), ms per pair."""
    if ms is None:
        return f"{name:12s} not timed (cpu)"
    rate = f"{n_bytes / ms / 1e6:8.1f} GB/s" if n_bytes else "       - GB/s"
    return f"{name:12s} {ms:9.4f} ms {rate}  ({ms / pairs:.4f} ms/pair)"


def per_call(ms: float | None, reps: int, points: int) -> tuple[float | None, float | None]:
    """(us per call, ns per point) of a loop of `reps` calls over
    `points` points that took `ms`; (None, None) untimed."""
    if ms is None:
        return None, None
    us = 1e3 * ms / reps
    return us, 1e3 * us / points


def rep_line(name: str, ms: float | None, reps: int, points: int) -> str:
    """One report line of a loop of `reps` calls timed as a whole: us
    per call and ns per point."""
    us, ns = per_call(ms, reps, points)
    if us is None:
        return f"{name:28s} not timed (cpu)"
    return f"{name:28s} {us:10.3f} us/call ({ns:9.2f} ns/point; {reps} calls in {ms:.4f} ms)"


def select(cases: dict, variants) -> list[str]:
    """The case names to run, in their order; raise on an unknown one."""
    if not variants:
        return list(cases)
    unknown = set(variants) - set(cases)
    if unknown:
        raise ValueError(f"unknown variants {sorted(unknown)}; known {list(cases)}")
    return [n for n in cases if n in variants]


def main_on_card(run, argv) -> int:
    """Command-line entry: run on the card, or fail without one."""
    if not torch.cuda.is_available():
        print("this harness needs a CUDA device", file=sys.stderr)
        return 1
    run(argv or None, device="cuda")
    return 0
