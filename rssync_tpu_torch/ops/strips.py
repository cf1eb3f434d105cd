"""The LK tracker's window fetches: the row-block gather and the
search-strip fetch (kernel K3 of rssync_tpu/frontend/tracking.py).

An image (T, H, Wp) with Wp % 128 == 0 is viewed as (T * H * Wp/128,
128) lane blocks; a window of S rows x 256 columns starting at row oy
and column 128 * obx is 2 consecutive blocks of each of S rows.

- `gather_blocks` fetches such windows with one `index_select`, rows
  and blocks clamped per row (edge replication). It is the tracker's
  general route and the plain version of K3.
- `gather_strips` fetches the (40, 256) strip at row 8 * oyq for every
  (pair, point), with indices the caller has clamped in bounds. On CPU
  tensors it computes the plain version `gather_strips_ref`; on CUDA
  tensors it launches the kernel of csrc/gather_strips.cu or raises.
  The kernel streams the strips through a shared-memory ring of a
  persistent grid with TMA copies.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator

import torch

from rssync_tpu_torch.ops import _kernels

LANE = 128
#: rows of a search strip: the largest fine-level window (S = 31) plus
#: the <= 7-row residual of quantizing its top row down to 8
STRIP_ROWS = 40

#: kernel launches, counted where the wrapper launches its kernel or a
#: CUDA graph that holds it runs (`count_replay`)
LAUNCHES = {"gather_strips": 0}
#: the (T, Hp, Wp, B, N, dtype) shapes the kernel was launched at
LAUNCH_SHAPES = {"gather_strips": set()}
#: this thread's open `captured_launches` tally
_CAPTURE = threading.local()

_DTYPE_NAMES = {torch.uint8: "torch.uint8", torch.float32: "torch.float32"}


def reset_launch_counters() -> None:
    """Zero LAUNCHES and empty LAUNCH_SHAPES."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        LAUNCH_SHAPES[name].clear()


@contextmanager
def captured_launches() -> Iterator[list]:
    """A launch this thread records into a CUDA graph capture inside the
    block does not run, so it is not counted in LAUNCHES: the yielded
    list takes its shape instead, one a launch, for `count_replay` to
    count each time the graph runs."""
    prev = getattr(_CAPTURE, "tally", None)
    _CAPTURE.tally = tally = []
    try:
        yield tally
    finally:
        _CAPTURE.tally = prev


def count_replay(tally: list) -> None:
    """Count the launches of one run of a graph: `captured_launches`'
    tally of its capture."""
    LAUNCHES["gather_strips"] += len(tally)
    LAUNCH_SHAPES["gather_strips"].update(tally)


def _block_rows(imgs: torch.Tensor, oy: torch.Tensor, obx: torch.Tensor,
                S: int, fidx: torch.Tensor | None) -> torch.Tensor:
    """(B, N, S, 256) windows in the image dtype; see gather_blocks."""
    T, H, Wp = imgs.shape
    NB = Wp // LANE
    src = imgs.reshape(T * H * NB, LANE)
    dev = imgs.device
    rows = torch.clamp(oy[..., None] + torch.arange(S, dtype=torch.int64, device=dev), 0, H - 1)
    blk = torch.clamp(obx[..., None, None] + torch.arange(2, dtype=torch.int64, device=dev),
                      0, NB - 1)  # (B, N, 1, 2)
    if fidx is None:
        fidx = torch.arange(T, device=dev)
    B, N = oy.shape
    base = fidx.to(torch.int64)[:, None, None] * H + rows  # (B, N, S)
    idx = base[..., None] * NB + blk  # (B, N, S, 2)
    return torch.index_select(src, 0, idx.reshape(-1)).reshape(B, N, S, 2 * LANE)


def gather_blocks(imgs: torch.Tensor, oy: torch.Tensor, obx: torch.Tensor,
                  S: int, fidx: torch.Tensor | None = None) -> torch.Tensor:
    """S-row x 256-column windows for every (pair, point) in one gather.

    imgs: (B, H, Wp), Wp % 128 == 0; oy: (B, N) integer top row; obx:
    (B, N) integer leftmost 128-column block. Returns (B, N, S, 256)
    float32; rows and blocks are clamped per row (edge replication).
    fidx: optional (B,) frame indices; imgs then holds a whole clip
    (T, H, Wp) and pair b reads frame fidx[b]."""
    return _block_rows(imgs, oy, obx, S, fidx).to(torch.float32)


def gather_strips_ref(imgs: torch.Tensor, oyq: torch.Tensor, obx: torch.Tensor,
                      fidx: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of `gather_strips`: the row-block gather of the
    strips, in the image dtype."""
    return _block_rows(imgs, oyq * 8, obx, STRIP_ROWS, fidx)


def strip_path_ok(img: torch.Tensor, n_pts: int) -> bool:
    """Static predicate of rssync_tpu's strip route: the level is big
    enough for whole strips, its dtype is uint8 or float32, and a
    pair's strips take at most 8 MB (the TPU's scoped-VMEM budget; kept
    because it decides which route the reference results took). Other
    levels take `gather_blocks`."""
    block = n_pts * STRIP_ROWS * 2 * LANE * img.element_size()
    return (
        img.shape[-2] >= STRIP_ROWS
        and img.shape[-1] >= 2 * LANE
        and img.dtype in (torch.uint8, torch.float32)
        and block <= 8_000_000
    )


def _check(imgs, oyq, obx, fidx) -> None:
    if imgs.dim() != 3:
        raise ValueError(f"gather_strips: imgs must be (T, Hp, Wp), got {tuple(imgs.shape)}")
    T, Hp, Wp = imgs.shape
    if imgs.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"gather_strips: imgs must be uint8 or float32, got {imgs.dtype}")
    if Wp % LANE or Wp < 2 * LANE or Hp < STRIP_ROWS:
        raise ValueError(
            f"gather_strips: image {Hp}x{Wp} needs Wp % {LANE} == 0, Wp >= {2 * LANE}, "
            f"Hp >= {STRIP_ROWS}")
    if oyq.dim() != 2 or oyq.shape != obx.shape:
        raise ValueError(
            f"gather_strips: oyq {tuple(oyq.shape)} and obx {tuple(obx.shape)} must be (B, N)")
    if fidx is not None and tuple(fidx.shape) != (oyq.shape[0],):
        raise ValueError(f"gather_strips: fidx {tuple(fidx.shape)} must be ({oyq.shape[0]},)")
    if fidx is None and oyq.shape[0] != T:
        raise ValueError(f"gather_strips: {oyq.shape[0]} pairs need fidx for {T} frames")
    dev = imgs.device
    if oyq.device != dev or obx.device != dev or (fidx is not None and fidx.device != dev):
        devices = {t.device for t in (imgs, oyq, obx, fidx) if t is not None}
        raise ValueError(f"gather_strips: tensors on several devices {devices}")


def _launch(imgs, oyq, obx, fidx) -> torch.Tensor:
    """Launch the kernel (fidx may be None: pair b reads frame b). The
    checks of `_check` come first."""
    dev = imgs.device
    if dev.type != "cuda":
        raise ValueError(f"gather_strips: unsupported device {dev}")
    for name, t in (("oyq", oyq), ("obx", obx), ("fidx", fidx)):
        if t is not None and t.dtype != torch.int32:
            raise TypeError(f"gather_strips: {name} must be int32, got {t.dtype}")
    if not (imgs.is_contiguous() and oyq.is_contiguous() and obx.is_contiguous()
            and (fidx is None or fidx.is_contiguous())):
        raise ValueError("gather_strips: inputs must be contiguous")
    if imgs.data_ptr() % 16:
        raise ValueError("gather_strips: image rows must be 16-byte aligned")
    T, Hp, Wp = imgs.shape
    B, N = oyq.shape
    if B * N >= 2**31 or T * Hp >= 2**31:
        raise ValueError(f"gather_strips: {B * N} strips or {T * Hp} image rows exceed the "
                         "kernel's 32-bit indices")
    out = torch.empty((B, N, STRIP_ROWS, 2 * LANE), dtype=imgs.dtype, device=dev)
    if B * N == 0:
        return out
    lib = _kernels.load()
    index = dev.index
    # the C launch makes `index` the current device for the launch; the raw
    # stream handle skips building a torch Stream a call
    rc = lib.gather_strips_launch(
        imgs.data_ptr(), oyq.data_ptr(), obx.data_ptr(),
        None if fidx is None else fidx.data_ptr(), out.data_ptr(), B, N, T, Hp, Wp,
        imgs.element_size(), index, torch._C._cuda_getCurrentRawStream(index),
    )
    if rc != 0:
        raise RuntimeError(
            f"gather_strips launch failed: {lib.gather_strips_error_string(rc).decode()}")
    shape = (T, Hp, Wp, B, N, _DTYPE_NAMES[imgs.dtype])
    if torch.cuda.is_current_stream_capturing():
        tally = getattr(_CAPTURE, "tally", None)
        if tally is not None:
            tally.append(shape)
    else:
        LAUNCHES["gather_strips"] += 1
        LAUNCH_SHAPES["gather_strips"].add(shape)
    return out


def gather_strips(imgs: torch.Tensor, oyq: torch.Tensor, obx: torch.Tensor,
                  fidx: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N, 40, 256) strips at rows [8 * oyq, 8 * oyq + 40) and
    columns [128 * obx, 128 * obx + 256) of frame fidx[b] (frame b
    without fidx), in the image dtype. imgs: (T, Hp, Wp) uint8 or
    float32 with Wp % 128 == 0; oyq, obx: (B, N) int32 clamped so every
    strip lies inside the image; fidx: optional (B,) int32. Replaces
    rssync_tpu/frontend/tracking.py _gather_strips_pallas."""
    _check(imgs, oyq, obx, fidx)
    if imgs.device.type == "cpu":
        return gather_strips_ref(imgs, oyq, obx, fidx)
    return _launch(imgs, oyq, obx, fidx)
