"""How fast does the card touch u8 pixels? Port of experiments/r4_u8pass.py
(kernel E5): whole-clip passes over 241 frames of 2704x2028, stored
2816x2056 (1.40 GB of u8), one call each:

  sum_u8_i32    torch.sum(u8, dtype=int32)
  sum_u8_bf16   u8 -> bf16, then a float32-accumulated sum
  sum_bf16      float32-accumulated sum of bf16 frames
  sum_f32       sum of float32 frames
  conv_mat      u8 -> bf16 materialized by .to(bfloat16), tiny strided sum
  kernel_conv   the same convert by the port's kernel (ops/convert.py)

bf16 and float32 copies are made on the card first. GB/s divides the
bytes each variant must move, as the original counts them (the u8 read
once; bf16 and f32 reads; 3 bytes a pixel for a converted copy), by the
CUDA-event time; torch runs sum_u8_bf16 unfused and moves more.
The TPU kernel converts Hp // 256 row blocks and leaves rows 2048-2055
of each frame unwritten; the port's kernel converts every row.

    python -m rssync_tpu_torch.experiments.r4_u8pass [variants]
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
from rssync_tpu_torch.ops.convert import u8_to_bf16


def tiny(y: torch.Tensor) -> torch.Tensor:
    """A strided sum that reads one pixel in 128 x 512 of a converted copy."""
    return torch.sum(y[:, ::128, ::512].float())


def cases(u8: torch.Tensor) -> dict:
    """{name: (call, bytes it must move)} over the frames `u8`; the
    derived bf16 and float32 copies are made at first use."""
    nb = u8.numel()
    derived = {}

    def as_(dtype):
        if dtype not in derived:
            derived[dtype] = u8.to(dtype)
        return derived[dtype]

    return {
        "sum_u8_i32": (lambda: torch.sum(u8, dtype=torch.int32), nb),
        "sum_u8_bf16": (lambda: torch.sum(u8.to(torch.bfloat16), dtype=torch.float32), nb),
        "sum_bf16": (lambda: torch.sum(as_(torch.bfloat16), dtype=torch.float32), 2 * nb),
        "sum_f32": (lambda: torch.sum(as_(torch.float32)), 4 * nb),
        "conv_mat": (lambda: tiny(u8.to(torch.bfloat16)), 3 * nb),
        "kernel_conv": (lambda: tiny(u8_to_bf16(u8)), 3 * nb),
    }


def run(variants=None, device="cuda", small: bool = False, frames=None) -> dict:
    """Run the variants (all by default); {name: {ms, bytes, value}}.
    frames: the (241, 2056, 2816) u8 clip on `device`, made here if None."""
    dev = torch.device(device)
    p = point(small)
    print(card_line(dev), flush=True)
    u8 = make_frames(dev, small) if frames is None else frames
    table = cases(u8)
    out = {}
    for name in select(table, variants):
        fn, n_bytes = table[name]
        value, ms = timed(fn, dev)
        out[name] = dict(ms=ms, bytes=n_bytes, value=float(value))
        print(line(name, ms, n_bytes, p.seg), flush=True)
    return out


def main(argv=None) -> int:
    return main_on_card(run, sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    raise SystemExit(main())
