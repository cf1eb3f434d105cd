"""Per-point search strips: the strip kernel against the row-block
gather. Port of experiments/r3_dma.py (kernel E2) at its operating
point: B = 16 unpadded u8 frames of 2028 x 2816 from numpy seed 0,
N = 130 points a frame, 40 x 256 strips, 31-row gather windows:

  kernel-strips  REPS chained extractions of the (40, 256) strips by
                 K3's kernel (ops/strips.py::gather_strips; pair b reads
                 frame b), row blocks (oy + i) % 248, each summed in f32
  gather-blocks  REPS chained row-block gathers (ops/strips.py::
                 gather_blocks) of 31 rows at (8 oy + i) % (H - 31),
                 each summed in f32

The two read different windows, as in the experiment, so their sums
differ; the correctness line holds the kernel's strips to the gather's
at the same origins, bit for bit. Each variant reports us per
extraction and per point over its REPS loop, timed as one with CUDA
events.

    python -m rssync_tpu_torch.experiments.r3_dma [variants]
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch

from rssync_tpu_torch.experiments._harness import (
    card_line,
    main_on_card,
    per_call,
    rep_line,
    select,
    timed,
)
from rssync_tpu_torch.ops.strips import LANE, STRIP_ROWS, gather_blocks, gather_strips

#: rows of the gather's window (the tracker's fine-level search window)
S = 31


@dataclass(frozen=True)
class Shape:
    """`frames` frames of height x width, `points` points each, `reps`
    chained extractions."""

    frames: int
    height: int
    width: int
    points: int
    reps: int


FULL = Shape(16, 2028, 2816, 130, 200)
SMALL = Shape(2, 64, 384, 6, 3)


def shape(small: bool) -> Shape:
    return SMALL if small else FULL


def make_inputs(device, small: bool = False, seed: int = 0):
    """(frames u8, oy, obx int32) on `device` from a numpy seed: oy a
    row block in [0, (H - 40) // 8), obx a 128-column block whose
    256-column strip lies in the frame."""
    p = shape(small)
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (p.frames, p.height, p.width), dtype=np.uint8)
    oy = rng.integers(0, (p.height - STRIP_ROWS) // 8, (p.frames, p.points))
    obx = rng.integers(0, p.width // LANE - 1, (p.frames, p.points))
    i32 = dict(dtype=torch.int32, device=device)
    return torch.from_numpy(img).to(device), torch.tensor(oy, **i32), torch.tensor(obx, **i32)


def cases(img: torch.Tensor, oy: torch.Tensor, obx: torch.Tensor, reps: int) -> dict:
    """{name: call}; each call returns the f32 sum of its `reps`
    extractions."""
    H = img.shape[1]
    blocks = (H - STRIP_ROWS) // 8

    def chain(extract):
        def call():
            tot = torch.zeros((), dtype=torch.float32, device=img.device)
            for i in range(reps):
                tot = tot + torch.sum(extract(i), dtype=torch.float32)
            return tot

        return call

    return {
        "kernel-strips": chain(lambda i: gather_strips(img, (oy + i) % blocks, obx)),
        "gather-blocks": chain(lambda i: gather_blocks(img, (8 * oy + i) % (H - S), obx, S)),
    }


def run(variants=None, device="cuda", small: bool = False) -> dict:
    """Run the variants (all by default). Returns {"match": the strips
    equal the row-block gather, name: {ms, us_per_call, ns_per_point,
    value}}."""
    dev = torch.device(device)
    p = shape(small)
    print(card_line(dev), flush=True)
    img, oy, obx = make_inputs(dev, small)
    strips = gather_strips(img, oy, obx)
    match = bool(torch.equal(strips, gather_blocks(img, 8 * oy, obx, STRIP_ROWS).to(torch.uint8)))
    print(f"# correctness vs the row-block gather: {match}", flush=True)
    out = {"match": match}
    table = cases(img, oy, obx, p.reps)
    for name in select(table, variants):
        value, ms = timed(table[name], dev)
        us, ns = per_call(ms, p.reps, p.frames * p.points)
        out[name] = dict(ms=ms, us_per_call=us, ns_per_point=ns, value=float(value))
        print(rep_line(name, ms, p.reps, p.frames * p.points), flush=True)
    return out


def main(argv=None) -> int:
    return main_on_card(run, sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    raise SystemExit(main())
