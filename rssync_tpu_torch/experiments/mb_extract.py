"""Strategies for extracting N small square windows at per-point origins
from one image: port of experiments/mb_extract.py (kernel E3), at its
operating point: a 2028 x 2704 u8 image from numpy seed 0 (and its
bf16 and f32 copies), N = 130 origins from a numpy seed in [0, 1500),
40 x 40 windows, REPS = 50 calls at origins (o + i) % 1500, each call's
output summed so that nothing is dropped. Variants (the experiment's
label in brackets):

  dynslice_{u8,bf16,f32}       dynamic_slice's clamp + one advanced-index
                               gather [vmap(dynamic_slice)]
  onehot_mm_{u8,bf16}          one-hot rows matmul, then one-hot columns
                               batched matmul [one-hot matmul rows+cols]
  rowslice_colmm_{u8,bf16}     (N, 40, W) row windows by advanced
                               indexing + column one-hot batched matmul
                               [row-dynslice + col one-hot mm]
  rowtake_colmm_{u8,bf16}      the rows by one index_select + column
                               one-hot batched matmul [row-take + col
                               one-hot mm]
  kernel_{u8,bf16,f32}         E3's clamp (rows 40 + sub up to a multiple
                               of 8, sub 32/16/8 by dtype; cols 40 + 128)
                               + the port's kernel (ops/patches.py)
                               [pallas burst-DMA + vmem slice]

The one-hot variants multiply bf16-rounded operands in float32, where
XLA multiplied bf16 by bf16 into float32: torch's bf16 matmul returns
bf16. Every output is one exact pixel either way (u8 is exact in bf16),
so every variant extracts the same pixels, and the sums are taken in
float64, where they are exact whatever the order, so the variants agree
bit for bit. Each reports us per call and ns per point over its REPS
loop, timed as one with CUDA events.

    python -m rssync_tpu_torch.experiments.mb_extract [variants]
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
from rssync_tpu_torch.ops.patches import (
    LANE,
    clamp_aligned,
    clamp_slice,
    extract_patches,
    extract_patches_ref,
    row_align,
    slice_start,
)


@dataclass(frozen=True)
class Shape:
    """An image of height x width, `points` windows of `size`, `reps`
    calls at origins below `span`."""

    height: int
    width: int
    points: int
    size: int
    reps: int
    span: int


FULL = Shape(2028, 2704, 130, 40, 50, 1500)
SMALL = Shape(96, 300, 6, 8, 3, 50)

_NAMES = {torch.uint8: "u8", torch.bfloat16: "bf16", torch.float32: "f32"}


def shape(small: bool) -> Shape:
    return SMALL if small else FULL


def make_image(device, small: bool = False, seed: int = 0) -> torch.Tensor:
    """The experiment's u8 image, from a numpy seed, on `device`."""
    p = shape(small)
    img = np.random.default_rng(seed).integers(0, 255, (p.height, p.width), dtype=np.uint8)
    return torch.from_numpy(img).to(device)


def make_origins(device, n: int, small: bool = False, seed: int = 0) -> torch.Tensor:
    """(n, 2) int32 xy origins in [0, span) from a numpy seed, on
    `device`; every n draws from the same seed, as the experiments draw
    every origin set from one key."""
    o = np.random.default_rng(seed + 1).integers(0, shape(small).span, (n, 2))
    return torch.tensor(o, dtype=torch.int32, device=device)


def repeat(body, o0: torch.Tensor, p: Shape):
    """A call running body((o0 + i) % span) for i < reps and returning
    the float64 sum of all outputs."""
    def call():
        tot = torch.zeros((), dtype=torch.float64, device=o0.device)
        for i in range(p.reps):
            tot = tot + torch.sum(body((o0 + i) % p.span), dtype=torch.float64)
        return tot

    return call


def kernel_body(img: torch.Tensor, size: int, sub: int, patches_per_block: int = 1):
    """E3/E4's kernel route: the aligned region is (size + sub up to a
    multiple of 8) x (size + 128) rows x columns; origins clamped so it
    stays in the image, then the port's kernel."""
    H, W = img.shape
    rows = size + sub
    rows += (-rows) % 8
    cols = size + LANE

    def body(o):
        o = clamp_aligned(o, H, W, rows, cols, sub)
        return extract_patches(img, o, size, patches_per_block=patches_per_block)

    return body


def cases(u8: torch.Tensor, o0: torch.Tensor, p: Shape) -> dict:
    """{name: call} over the u8 image and its bf16 and f32 copies."""
    H, W = u8.shape
    S = p.size
    dev = u8.device
    images = {torch.uint8: u8, torch.bfloat16: u8.to(torch.bfloat16),
              torch.float32: u8.float()}
    ar_s, ar_h, ar_w = (torch.arange(n, device=dev) for n in (S, H, W))

    def bf16_f32(x):
        return x.to(torch.bfloat16).float()

    def col_onehot(o):  # (N, W, S): column o_x + s of window n
        cols = o[:, 0:1] + ar_s
        return (cols[:, None, :] == ar_w[None, :, None]).float()

    def dynslice(img):
        return lambda o: extract_patches_ref(img, clamp_slice(o, H, W, S), S)

    def onehot_mm(img):
        def body(o):
            rows = (o[:, 1:2] + ar_s).reshape(-1)
            oh_r = (rows[:, None] == ar_h[None, :]).float()  # (N * S, H)
            strips = (oh_r @ bf16_f32(img)).reshape(-1, S, W)
            return torch.bmm(bf16_f32(strips), col_onehot(o))

        return body

    def rowslice_colmm(img):
        def body(o):
            strips = img[slice_start(o[:, 1], H, S)[:, None] + ar_s]  # (N, S, W)
            return torch.bmm(bf16_f32(strips), col_onehot(o))

        return body

    def rowtake_colmm(img):
        def body(o):
            rows = (o[:, 1:2] + ar_s).reshape(-1)
            strips = torch.index_select(img, 0, rows).reshape(-1, S, W)
            return torch.bmm(bf16_f32(strips), col_onehot(o))

        return body

    table = {}
    for dt in images:
        table[f"dynslice_{_NAMES[dt]}"] = dynslice(images[dt])
    for make in (onehot_mm, rowslice_colmm, rowtake_colmm):
        for dt in (torch.uint8, torch.bfloat16):
            table[f"{make.__name__}_{_NAMES[dt]}"] = make(images[dt])
    for dt in images:
        table[f"kernel_{_NAMES[dt]}"] = kernel_body(images[dt], S, row_align(dt))
    return {name: repeat(body, o0, p) for name, body in table.items()}


def run(variants=None, device="cuda", small: bool = False) -> dict:
    """Run the variants (all by default); {name: {ms, us_per_call,
    ns_per_point, value, patches}}, value the float64 sum of the REPS
    calls' outputs, patches the (N, size) they extract."""
    dev = torch.device(device)
    p = shape(small)
    print(card_line(dev), flush=True)
    table = cases(make_image(dev, small), make_origins(dev, p.points, small), p)
    out = {}
    for name in select(table, variants):
        value, ms = timed(table[name], dev)
        us, ns = per_call(ms, p.reps, p.points)
        out[name] = dict(ms=ms, us_per_call=us, ns_per_point=ns, value=float(value),
                         patches=(p.points, p.size))
        print(rep_line(name, ms, p.reps, p.points), flush=True)
    return out


def main(argv=None) -> int:
    return main_on_card(run, sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    raise SystemExit(main())
