"""Is cutting a chunk out of the clip a cost of its own? Port of
experiments/r4_slice2.py (kernel E7), at the tracker's operating point
(240 pairs of 2704x2028 in 15 chunks of 16 pairs):

  slice_sum   narrow(frames, 0, s, 17) (a view at a host start) + int32 sum
  static_sum  the 16-frame chunks of a reshaped view + int32 sum
  kernel_sum  the 17 frames copied by the port's kernel from a start
              held on the card (ops/blockcopy.py) + int32 sum
  slice_pyr   narrow + the first sparse pyramid level (level 2) of
              frontend/tracking.py::build_pyramid_sparse, int32 sum
  static_pyr  the same over the reshaped view's 16-frame chunks

GB/s divides the bytes each sum variant must move (u8 read once; the
copy read and written once more) by the CUDA-event time of all 15
chunks; the pyramid variants report ms per pair.

    python -m rssync_tpu_torch.experiments.r4_slice2 [variants]
"""

from __future__ import annotations

import sys

import torch

from rssync_tpu_torch.experiments._harness import (
    LEVELS,
    card_line,
    line,
    main_on_card,
    make_frames,
    point,
    select,
    timed,
)
from rssync_tpu_torch.frontend import tracking as T
from rssync_tpu_torch.ops.blockcopy import copy_block


def _pyr1(hw: tuple[int, int]):
    """int32 sum of the first sparse pyramid level above 0 of a block."""
    need, lvl_plan, _ = T._level_plan(LEVELS, T.LK_ITERS, T.LK_RADIUS)
    first = sorted(set(need) - {0})[0]

    def pyr1(blk: torch.Tensor) -> torch.Tensor:
        p = T.build_pyramid_sparse(blk, LEVELS, [first], hw, lvl_plan)
        return torch.sum(p[first], dtype=torch.int32).float()

    return pyr1


def cases(frames: torch.Tensor, chunk: int, hw: tuple[int, int]) -> dict:
    """{name: (call, bytes it must move or None)}."""
    n_chunks = (frames.shape[0] - 1) // chunk
    frame_bytes = frames[0].numel()
    starts = range(0, n_chunks * chunk, chunk)
    starts_dev = torch.arange(n_chunks, dtype=torch.int32, device=frames.device) * chunk
    view = frames[: n_chunks * chunk].view(n_chunks, chunk, *frames.shape[1:])
    pyr1 = _pyr1(hw)

    def sum_i32(b):
        return torch.sum(b, dtype=torch.int32).float()

    def sliced(one):
        return torch.stack([one(frames.narrow(0, s, chunk + 1)) for s in starts])

    def static(one):
        return torch.stack([one(view[i]) for i in range(n_chunks)])

    def copied(one):
        return torch.stack([one(copy_block(frames, starts_dev[i : i + 1], chunk + 1))
                            for i in range(n_chunks)])

    block = n_chunks * (chunk + 1) * frame_bytes
    return {
        "slice_sum": (lambda: sliced(sum_i32), block),
        "static_sum": (lambda: static(sum_i32), n_chunks * chunk * frame_bytes),
        "kernel_sum": (lambda: copied(sum_i32), 3 * block),
        "slice_pyr": (lambda: sliced(pyr1), None),
        "static_pyr": (lambda: static(pyr1), None),
    }


def run(variants=None, device="cuda", small: bool = False, frames=None) -> dict:
    """Run the variants (all by default); {name: {ms, bytes, value}},
    value the sum of the per-chunk results. frames: the u8 clip on
    `device`, made here if None."""
    dev = torch.device(device)
    p = point(small)
    print(card_line(dev), flush=True)
    frames = make_frames(dev, small) if frames is None else frames
    table = cases(frames, p.chunk, (p.height, p.width))
    out = {}
    for name in select(table, variants):
        fn, n_bytes = table[name]
        value, ms = timed(fn, dev)
        out[name] = dict(ms=ms, bytes=n_bytes, value=float(value.double().sum()))
        print(line(name, ms, n_bytes, p.seg), flush=True)
    return out


def main(argv=None) -> int:
    return main_on_card(run, sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    raise SystemExit(main())
