"""Per-dtype pixel-pass rates in the tracker's chunked harness. Port of
experiments/r4_u8pass2.py (kernel E6): the 241-frame clip of
r4_u8pass.py in 15 chunks of 17 frames (16 pairs and the shared frame),
one pass per chunk, in a Python loop over frames[s : s + 17]:

  sum_u8       torch.sum(chunk, dtype=int32)
  sum_i16      int32 sum of int16 frames
  sum_bf16     float32-accumulated sum of bf16 frames
  sum_f32      sum of float32 frames
  conv         chunk -> bf16 materialized by .to(bfloat16), tiny sum
  kernel_conv  the same convert by the port's kernel (ops/convert.py;
               the TPU kernel went u8 -> i32 -> bf16, the same values)

int16, bf16 and float32 copies of the clip are made on the card first.
GB/s divides the bytes each variant must move over the 15 chunks (u8
read once; 2 or 4 bytes a pixel for wider frames; 3 for a converted
copy) by the CUDA-event time of all 15.

    python -m rssync_tpu_torch.experiments.r4_u8pass2 [variants]
"""

from __future__ import annotations

import sys

import torch

from rssync_tpu_torch.experiments._harness import (
    card_line,
    line,
    main_on_card,
    make_frames,
    point,
    select,
    timed,
)
from rssync_tpu_torch.experiments.r4_u8pass import tiny
from rssync_tpu_torch.ops.convert import u8_to_bf16


def chunked(frames: torch.Tensor, one, chunk: int) -> torch.Tensor:
    """one(frames[s : s + chunk + 1]) for s = 0, chunk, ..., stacked."""
    n_chunks = (frames.shape[0] - 1) // chunk
    return torch.stack([one(frames[s : s + chunk + 1])
                        for s in range(0, n_chunks * chunk, chunk)])


def cases(u8: torch.Tensor, chunk: int) -> dict:
    """{name: (call, bytes it must move)}; derived copies made at first use."""
    n_chunks = (u8.shape[0] - 1) // chunk
    nb = n_chunks * (chunk + 1) * u8[0].numel()
    derived = {}

    def as_(dtype):
        if dtype not in derived:
            derived[dtype] = u8.to(dtype)
        return derived[dtype]

    def sum_i32(b):
        return torch.sum(b, dtype=torch.int32).float()

    def sum_f32(b):
        return torch.sum(b, dtype=torch.float32)

    return {
        "sum_u8": (lambda: chunked(u8, sum_i32, chunk), nb),
        "sum_i16": (lambda: chunked(as_(torch.int16), sum_i32, chunk), 2 * nb),
        "sum_bf16": (lambda: chunked(as_(torch.bfloat16), sum_f32, chunk), 2 * nb),
        "sum_f32": (lambda: chunked(as_(torch.float32), sum_f32, chunk), 4 * nb),
        "conv": (lambda: chunked(u8, lambda b: tiny(b.to(torch.bfloat16)), chunk), 3 * nb),
        "kernel_conv": (lambda: chunked(u8, lambda b: tiny(u8_to_bf16(b)), chunk), 3 * nb),
    }


def run(variants=None, device="cuda", small: bool = False, frames=None) -> dict:
    """Run the variants (all by default); {name: {ms, bytes, value}},
    value the sum of the per-chunk results. frames: the u8 clip on
    `device`, made here if None."""
    dev = torch.device(device)
    p = point(small)
    print(card_line(dev), flush=True)
    u8 = make_frames(dev, small) if frames is None else frames
    table = cases(u8, p.chunk)
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
