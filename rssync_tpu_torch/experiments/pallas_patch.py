"""Square patches at per-patch origins: port of
experiments/pallas_patch.py (kernel E1).

`extract_patches(img, origins, size, force=None)` takes an (H, W)
uint8, bfloat16 or float32 image and (N, 2) xy origins and returns
(N, size, size) float32 patches, through one of E1's two routes:

  force="kernel"          E1's "pallas" route: origins clamped so the
                          TPU's aligned DMA region (rows to the dtype's
                          sublane tile, columns to 128) stays in the
                          image, then the port's kernel
                          (ops/patches.py -> csrc/extract_patches.cu)
  force="gather" or None  E1's "xla" route: dynamic_slice's clamp, then
                          the plain advanced-index gather

Near the right and bottom edges the kernel route clamps earlier than
the gather route, as E1's does; elsewhere the two agree bit for bit.
E1 has no harness of its own: chip_smoke.py calls this at E3's image
and origins (mb_extract.py) through both routes.
"""

from __future__ import annotations

import torch

from rssync_tpu_torch.ops.patches import (
    LANE,
    clamp_aligned,
    clamp_slice,
    extract_patches_ref,
    row_align,
)
from rssync_tpu_torch.ops.patches import extract_patches as _kernel


def aligned_region(dtype: torch.dtype, size: int) -> tuple[int, int, int]:
    """(rows, cols, ra) of E1's aligned region: ra the dtype's row tile,
    rows = size + ra up to a multiple of 8, cols = size + 128 up to a
    multiple of 128 (experiments/pallas_patch.py:103-108)."""
    ra = row_align(dtype)
    rows = size + ra
    rows += (-rows) % 8
    cols = (size + LANE + LANE - 1) // LANE * LANE
    return rows, cols, ra


def extract_patches(img: torch.Tensor, origins: torch.Tensor, size: int,
                    force: str | None = None) -> torch.Tensor:
    """(H, W) image + (N, 2) xy origins -> (N, size, size) float32.
    force: "kernel" | "gather" | None (the gather)."""
    origins = origins.to(torch.int32)
    H, W = img.shape
    if force == "kernel":
        rows, cols, ra = aligned_region(img.dtype, size)
        if H < rows or W < cols:
            raise ValueError(f"image {H}x{W} smaller than aligned DMA region {rows}x{cols}")
        return _kernel(img, clamp_aligned(origins, H, W, rows, cols, ra), size)
    if force in (None, "gather"):
        return extract_patches_ref(img, clamp_slice(origins, H, W, size), size)
    raise ValueError(f"unknown force {force!r}; known 'kernel', 'gather', None")
