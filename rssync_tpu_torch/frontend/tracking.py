"""Feature tracking: pyramidal Lucas-Kanade of a fixed grid on the
device, with rolling-shutter timestamps and fisheye ray lifting.

Port of rssync_tpu/frontend/tracking.py (its design notes and
measurements are the TPU's; this module keeps its algorithm and the
values it computes). The reference runs OpenCV DIS dense flow per
frame pair and samples it at a fixed grid (src/core_testcode.cpp:
97-162); here only the ~130 grid points are tracked:

  1. coarse motion, dense and global: a global-translation SAD argmin
     at a ~16 px pyramid level, then a (2D+1)^2 shifted-SAD cost volume
     at a ~64 px level with parabolic subpixel refinement, the flow
     field sampled bilinearly at the grid by one small matmul;
  2. fine refinement: iterative LK on the 2-3 finest levels. Each
     point's search region is fetched once per level (the strip fetch,
     kernel K3 in ops/strips.py, or the row-block gather), and every
     fractional window sample inside the Gauss-Newton steps is two
     batched matmuls against 2-tap interpolation matrices.

The pyramid keeps only the levels the schedule reads, each computed
from the previous one by two matmuls against banded downsampling
matrices whose weights are rounded to bfloat16 (rssync_tpu multiplies
bf16 operands with f32 accumulation; u8 pixels are exact in bf16). The
port multiplies in float64, where u8 pixels times these weights sum
exactly (at most 47 significant bits): a level then does not depend on
the GEMM's summation order, so neither on the batch it is computed in
(the hybrid structure's whole-clip levels equal the block's) nor on the
device. Float32 sums are not exact from level 5 on (28 bits after the
first GEMM), and a batch of 241 frames against one of 17 moved a level-5
pixel by one u8 level on an H100.

Entry points take their device from the frames tensor. Frames are
(T, H, W) uint8 or float32; points are (N, 2) xy pixels.

The block runner of `track_clip` and `track_frames` (`_track_blocks`)
makes the grid's device forms (`GridForms`) and its rays once a call,
so a block copies nothing from the host. On a CUDA device a block's
~570 small kernels then have fixed shapes and no host read, so each
stage (pyramid, coarse stage, LK levels) is captured once as a CUDA
graph, kept per device and block shape, and replayed a block: the same
kernels in the same order on the same values, so the tracks are
bit-equal to the eager block's. The CPU, and the other entry points,
run the blocks eagerly.

Video decode (cv2 on the host, imported only where frames are decoded)
feeds `track_frames`, the tracking stage of the recipe pipeline:
`VideoSource` (raw-luma fast path), the decode-ahead `FrameFeed`
thread, and the multiprocess decode pool (frontend/decode_pool.py),
chosen per run by `_range_feeds`.
"""

from __future__ import annotations

import itertools
import math
import threading
from collections import deque
from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Iterator, Sequence

import numpy as np
import torch

from rssync_tpu_torch.ops import lens as lens_ops
from rssync_tpu_torch.ops.strips import (
    LANE,
    STRIP_ROWS,
    captured_launches,
    count_replay,
    gather_blocks,
    gather_strips,
    strip_path_ok,
)
from rssync_tpu_torch.utils.graphs import GraphCache
from rssync_tpu_torch.utils.graphs import capture as capture_graphs
from rssync_tpu_torch.utils.timing import count, recording_on, span

LK_RADIUS = 10  # 21x21 window
LK_ITERS = 10  # API default; the schedule runs fewer per level (_fine_plan)

#: fine-level margins: the iterate may wander +-(margin-1) px from the
#: incoming guess within one level; the entry level's margin absorbs
#: the coarse stage's error
MARGIN_ENTRY = 8
MARGIN_FINE = 3

#: local cost-volume search radius (px at the volume level)
VOL_D = 4
#: box-filter half-width of the volume SAD (5x5)
VOL_BOX = 2

#: extra edge-replicated bottom rows on fine-level images, so strips of
#: windows that overhang the bottom edge stay in bounds
STRIP_PAD = 24

#: frame pairs per tracking launch
TRACK_BLOCK = 16
#: blocks `_track_blocks` keeps in flight (sliced or decoded and
#: uploaded, tracking) before it drains the oldest
TRACK_DEPTH = 3

#: pyramid depth from which `_fine_plan` takes the deep plan (frames of
#: ~1500 px and up)
DEEP_LEVELS = 7

_F32 = torch.float32


def auto_levels(height: int, width: int) -> int:
    """Pyramid depth so the coarsest level is ~12-24 px across."""
    m = min(height, width)
    return max(1, int(math.floor(math.log2(m / 12))) + 1)


def auto_grid_step(width: int) -> int:
    """The reference's step of 200 px at 2704 wide
    (ref: core_testcode.cpp:127), scaled with the width, at least 40."""
    return max(40, round(200 * width / 2704))


def grid_points(width: int, height: int, step: int | None = None) -> np.ndarray:
    """The reference's sampling grid: x-major from (step, step)
    (ref: core_testcode.cpp:125-132). (N, 2) float64."""
    if step is None:
        step = auto_grid_step(width)
    pts = [
        [float(i), float(j)]
        for i in range(step, width, step)
        for j in range(step, height, step)
    ]
    return np.asarray(pts, np.float64)


# ---------------------------------------------------------------------------
# pyramid


def _pool_mat_np(n: int) -> np.ndarray:
    """(n//2, n) banded matrix of the 2x2 average step along one axis
    (level 0 -> 1): row r averages input elements 2r, 2r+1."""
    m = np.zeros((n // 2, n), np.float64)
    r = np.arange(n // 2)
    m[r, 2 * r] = 0.5
    m[r, 2 * r + 1] = 0.5
    return m


def _blurdec_mat_np(n: int) -> np.ndarray:
    """(ceil(n/2), n) banded matrix of one blur + decimate step along
    one axis (levels >= 1): rows are the [1 4 6 4 1]/16 kernel centered
    at even input positions, edge-clamped."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float64) / 16.0
    out = (n - 1) // 2 + 1
    m = np.zeros((out, n), np.float64)
    for r in range(out):
        for i in range(5):
            c = min(max(2 * r + i - 2, 0), n - 1)
            m[r, c] += k[i]
    return m


@lru_cache(maxsize=None)
def _down_mat(n: int, src_lvl: int, dst_lvl: int) -> np.ndarray:
    """Composed banded matrix taking a length-n level-`src_lvl` axis to
    level `dst_lvl` in one multiply (the product of the per-level step
    matrices, composed on the host in f64)."""
    m = None
    size = n
    for lvl in range(src_lvl, dst_lvl):
        step = _pool_mat_np(size) if lvl == 0 else _blurdec_mat_np(size)
        m = step if m is None else step @ m
        size = step.shape[0]
    return m.astype(np.float32)


def _lvl_size(n: int, src_lvl: int, dst_lvl: int) -> int:
    """Logical axis length after downsampling src_lvl -> dst_lvl."""
    for lvl in range(src_lvl, dst_lvl):
        n = n // 2 if lvl == 0 else (n - 1) // 2 + 1
    return n


@lru_cache(maxsize=None)
def _down_mat_stored(n: int, src_lvl: int, dst_lvl: int,
                     n_store: int, out_store: int) -> np.ndarray:
    """`_down_mat` with storage padding folded into the weights: zero
    columns for padded source entries and a replicated last row for
    edge-padded output entries, so the pyramid emits padded levels with
    no separate pad pass."""
    m = _down_mat(n, src_lvl, dst_lvl)
    if n_store > n:
        m = np.pad(m, ((0, 0), (0, n_store - n)))
    if out_store > m.shape[0]:
        m = np.concatenate(
            [m, np.repeat(m[-1:], out_store - m.shape[0], axis=0)]
        )
    return m.astype(np.float32)


@lru_cache(maxsize=64)
def _down_weights(n: int, src_lvl: int, dst_lvl: int, n_store: int,
                  out_store: int, device: torch.device) -> torch.Tensor:
    """`_down_mat_stored` on `device`, rounded to bfloat16 (as
    rssync_tpu feeds it to its bf16 matmul) and held in float64."""
    m = torch.from_numpy(_down_mat_stored(n, src_lvl, dst_lvl, n_store, out_store))
    return m.to(torch.bfloat16).to(torch.float64).to(device)


def _stored_dims(h: int, w: int, kind: str | None) -> tuple[int, int]:
    """Storage dims of a level: 'fine' = strip row pad + lane pad (as
    _pad_lanes(img, True)); 'lane' = lane pad only; None = logical."""
    wp = -(-w // LANE) * LANE
    if kind == "fine":
        return -(-(h + STRIP_PAD) // 8) * 8, wp
    if kind == "lane":
        return h, wp
    return h, w


def _needed_levels(levels: int, iters: int, radius: int) -> list[int]:
    """The pyramid levels the schedule reads: the fine-plan levels plus
    the two coarse-init levels ({0, 2, 5, 7} at 2704x2028)."""
    need = {lvl for lvl, _it, _m, _r in _fine_plan(levels, iters, radius)}
    return sorted(need | set(_coarse_levels(levels, iters, radius) or ()))


def _cast_like(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Back to the image dtype: integers round half to even and clip."""
    if not dtype.is_floating_point:
        return torch.clamp(torch.round(x), 0, 255).to(dtype)
    return x.to(dtype)


def build_pyramid_sparse(
    img: torch.Tensor, levels: int, need: list[int],
    logical_hw: tuple[int, int] | None = None,
    pad_plan: dict[int, str | None] | None = None,
) -> dict[int, torch.Tensor]:
    """The levels in `need` only, each from the previous needed level by
    two matmuls (rows, then columns) against composed banded matrices.
    Pixels and weights are rounded to bfloat16, the products summed in
    float64 (exactly, for u8 levels: see the module docstring). img: (B, H, W); with `logical_hw` (the unpadded level-0
    dims; img may then carry storage padding) and `pad_plan` ({level:
    'fine' | 'lane' | None}, see _stored_dims) every level is emitted
    with its storage padding folded into the weights. Returns {level:
    (B, h_l, w_l)} in the input dtype."""
    logical_hw = logical_hw if logical_hw is not None else img.shape[-2:]
    weights = _pyramid_weights(img.shape[-2:], logical_hw, need, pad_plan or {}, img.device)
    pyr: dict[int, torch.Tensor] = {}
    prev = img
    for lvl in sorted(set(need)):
        if lvl in weights:
            R, C = weights[lvl]
            x = prev.to(torch.bfloat16).to(torch.float64)
            prev = _cast_like(torch.matmul(torch.matmul(R, x), C.T), img.dtype)
        pyr[lvl] = prev
    return pyr


def _pyramid_weights(stored_hw, logical_hw, need, pad_plan: dict,
                     device: torch.device) -> dict[int, tuple[torch.Tensor, torch.Tensor]]:
    """{level: (R, C)}: the row and column weights `build_pyramid_sparse`
    takes each needed level > 0 from the previous needed level with.
    stored_hw / logical_hw: level 0's storage and unpadded dims."""
    out = {}
    prev_lvl, (hs, ws), (h, w) = 0, tuple(stored_hw), tuple(logical_hw)
    for lvl in sorted(set(need) - {0}):
        hd, wd = _lvl_size(h, prev_lvl, lvl), _lvl_size(w, prev_lvl, lvl)
        hs_d, ws_d = _stored_dims(hd, wd, pad_plan.get(lvl))
        out[lvl] = (_down_weights(h, prev_lvl, lvl, hs, hs_d, device),
                    _down_weights(w, prev_lvl, lvl, ws, ws_d, device))
        prev_lvl, (hs, ws), (h, w) = lvl, (hs_d, ws_d), (hd, wd)
    return out


def _edge_pad(x: torch.Tensor, top: int, bottom: int, left: int,
              right: int) -> torch.Tensor:
    """Edge-replicating pad of the last two axes, any dtype."""
    H, W = x.shape[-2:]
    dev = x.device
    if top or bottom:
        x = x.index_select(-2, torch.clamp(torch.arange(-top, H + bottom, device=dev), 0, H - 1))
    if left or right:
        x = x.index_select(-1, torch.clamp(torch.arange(-left, W + right, device=dev), 0, W - 1))
    return x


def _pad_lanes(img: torch.Tensor, strip_rows: bool = False) -> torch.Tensor:
    """Edge-pad the width to a multiple of 128, so the image views as
    (rows * blocks, 128) lane blocks; with strip_rows=True (fine levels)
    also edge-pad the bottom by STRIP_PAD rows rounded up to 8, so
    strips of windows over the bottom edge stay in bounds."""
    H, W = img.shape[-2:]
    Hp, Wp = _stored_dims(H, W, "fine" if strip_rows else "lane")
    return _edge_pad(img, 0, Hp - H, 0, Wp - W)


def pad_frames_host(frames: np.ndarray, levels: int | None = None,
                    radius: int = LK_RADIUS,
                    iters: int = LK_ITERS) -> np.ndarray:
    """Edge-pad a (T, H, W) numpy frame block to the tracker's level-0
    storage dims on the host (feed it with logical_hw)."""
    T, H, W = frames.shape
    if levels is None:
        levels = auto_levels(H, W)
    fine0 = 0 in {l for l, *_ in _fine_plan(levels, iters, radius)}
    Hp, Wp = _stored_dims(H, W, "fine" if fine0 else "lane")
    if (Hp, Wp) == (H, W):
        return frames
    out = np.empty((T, Hp, Wp), frames.dtype)
    out[:, :H, :W] = frames
    out[:, H:, :W] = frames[:, -1:, :]
    out[:, :, W:] = out[:, :, W - 1 : W]
    return out


def stack_pad_host(grays: list, n_total: int, H: int, W: int,
                   Hp: int, Wp: int, out: np.ndarray | None = None) -> np.ndarray:
    """A (n_total, Hp, Wp) storage-padded u8 block from a list of (H, W)
    frames in one host copy, the last frame repeated to fill the tail;
    equal to pad_frames_host(np.stack(grays + [last] * tail)). `out`: a
    (n_total, Hp, Wp) u8 buffer to fill (pinned memory for an
    asynchronous upload), else a new one."""
    k = len(grays)
    if out is None:
        out = np.empty((n_total, Hp, Wp), np.uint8)
    for i, g in enumerate(grays):
        out[i, :H, :W] = g
        out[i, H:, :W] = g[-1:, :]
    out[:k, :, W:] = out[:k, :, W - 1 : W]
    if k < n_total:
        out[k:] = out[k - 1]
    return out


# ---------------------------------------------------------------------------
# batched window machinery


def _tap2(pos: torch.Tensor, size: int, width: int) -> torch.Tensor:
    """2-tap linear-interpolation matrix T[..., i, c] = max(0,
    1 - |pos + i - c|), so T @ v samples v at positions pos + i.
    Positions are clamped to [0, width - 1], so out-of-range samples
    edge-replicate the buffer; this is what lets the strip route's
    roff/rem go negative for windows over the top/left edge. pos: (...,)
    float32. Returns (..., size, width)."""
    dev = pos.device
    p = pos[..., None, None] + torch.arange(size, dtype=_F32, device=dev)[:, None]
    p = torch.clamp(p, 0.0, float(width - 1))
    c = torch.arange(width, dtype=_F32, device=dev)
    return torch.clamp(1.0 - torch.abs(p - c), min=0.0)


def _sample_windows(wide: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor,
                    rows: int, cols: int) -> torch.Tensor:
    """Bilinear windows from fetched regions: wide (B, N, S, Sw) float32,
    fy/fx (B, N) fractional window origins inside the region. Returns
    (B, N, rows, cols)."""
    Ry = _tap2(fy, rows, wide.shape[2])
    Cx = _tap2(fx, cols, wide.shape[3])
    part = torch.matmul(Ry, wide)  # (B, N, rows, Sw)
    return torch.matmul(part, Cx.transpose(-1, -2))  # (B, N, rows, cols)


def _extract_patches(imgs: torch.Tensor, pts: torch.Tensor, size: int) -> torch.Tensor:
    """(B, N, size, size) float32 bilinear patches with top-left corner
    at `pts` (B, N, 2) fractional xy. imgs: (B, H, Wp) lane-padded."""
    base = torch.floor(pts)
    frac = pts - base
    oy = base[..., 1].to(torch.int64)
    ox = base[..., 0].to(torch.int64)
    # clamp the block, keep a possibly negative remainder: left-edge
    # overhangs edge-replicate through the clamped taps
    obx = torch.clamp(torch.div(ox, LANE, rounding_mode="floor"), 0,
                      max(imgs.shape[-1] // LANE - 2, 0))
    rem = (ox - obx * LANE).to(_F32)
    wide = gather_blocks(imgs, oy, obx, size + 1)
    return _sample_windows(wide, frac[..., 1], rem + frac[..., 0], size, size)


def _patch_index(origins: np.ndarray, size: int, hw: tuple[int, int],
                 device: torch.device) -> tuple:
    """The gather index of `_extract_patches_static`: (N, size) int64 rows
    and columns of the patches at host INTEGER origins (N, 2), clamped to
    an (H, W) image (edge replication), on `device`, and (H, W)."""
    H, W = hw
    xs = origins[:, 0].astype(np.int64)
    ys = origins[:, 1].astype(np.int64)
    ar = np.arange(size)
    rows = torch.from_numpy(np.clip(ys[:, None] + ar, 0, H - 1)).to(device)
    cols = torch.from_numpy(np.clip(xs[:, None] + ar, 0, W - 1)).to(device)
    return rows, cols, (H, W)


def _gather_patches(imgs: torch.Tensor, index: tuple) -> torch.Tensor:
    """(B, N, size, size) float32 patches of imgs (B, H, W) at a
    `_patch_index`, made for images of imgs' (H, W)."""
    rows, cols, hw = index
    if tuple(imgs.shape[-2:]) != hw:
        raise ValueError(f"patch index for {hw} images, got {tuple(imgs.shape[-2:])}")
    return imgs[:, rows[:, :, None], cols[:, None, :]].to(_F32)


def _extract_patches_static(imgs: torch.Tensor, origins: np.ndarray,
                            size: int) -> torch.Tensor:
    """(B, N, size, size) float32 patches at host INTEGER origins (N, 2),
    rows and columns clamped to the image (edge replication). With
    integer origins the bilinear taps of `_extract_patches` are one-hot,
    so this is the same values by one index gather (rssync_tpu selects
    them with a one-hot matmul, exact in its bf16/f32 passes)."""
    return _gather_patches(imgs, _patch_index(origins, size, imgs.shape[-2:], imgs.device))


def _lk_templates(img_a: torch.Tensor, pts_level, radius: int,
                  index: tuple | None = None) -> dict:
    """Template patches, gradients and Gauss-Newton normal-matrix terms
    of every frame in img_a at pts_level: the img_a half of an LK level.

    img_a: (B, H, Wp) lane-padded level images. pts_level: (N, 2) or
    (B, N, 2). index: the `_patch_index` of pts_level - (radius + 1),
    which `grid_forms` makes where the points are whole numbers: the
    patches are then gathered there (the static-template route), else
    sampled bilinearly. Returns a dict of (B, N, ...) tensors."""
    w = 2 * radius + 1
    B = img_a.shape[0]
    if index is not None:
        patch_a = _gather_patches(img_a, index)
    else:
        p = torch.as_tensor(pts_level, dtype=_F32, device=img_a.device)
        if p.dim() == 2:
            p = p[None].expand(B, *p.shape)
        # template patch (w+2)^2 for central-difference gradients
        patch_a = _extract_patches(img_a, p - (radius + 1), w + 2)
    ix = 0.5 * (patch_a[..., 1:-1, 2:] - patch_a[..., 1:-1, :-2])
    iy = 0.5 * (patch_a[..., 2:, 1:-1] - patch_a[..., :-2, 1:-1])
    t = patch_a[..., 1:-1, 1:-1]
    gxx = torch.sum(ix * ix, dim=(-2, -1))
    gxy = torch.sum(ix * iy, dim=(-2, -1))
    gyy = torch.sum(iy * iy, dim=(-2, -1))
    det = gxx * gyy - gxy * gxy
    inv_ok = det > 1e-6
    det_safe = torch.where(inv_ok, det, torch.ones_like(det))
    return {
        "t": t, "ix": ix, "iy": iy, "gxx": gxx, "gxy": gxy, "gyy": gyy,
        "det_safe": det_safe, "inv_ok": inv_ok,
    }


def _lk_level(img_a, img_b, pts_level, guess, radius: int, iters: int,
              margin: int, edges: bool = False, index: tuple | None = None):
    """One pyramid level of iterative LK for all (pair, point).
    img_a/img_b: (B, H, Wp) lane-padded level images; pts_level (N, 2)
    or (B, N, 2) at this level's scale; guess (B, N, 2) incoming
    displacement; index: the templates' (`_lk_templates`). Returns
    (B, N, 2) (and, with edges, `_lk_iterate`'s edge counts)."""
    tmpl = _lk_templates(img_a, pts_level, radius, index)
    return _lk_iterate(img_b, pts_level, guess, tmpl, radius, iters, margin, edges=edges)


def _lk_iterate(img_b, pts_level, guess, tmpl, radius: int, iters: int,
                margin: int, fidx: torch.Tensor | None = None, edges: bool = False):
    """The img_b half of an LK level: fetch each point's search region
    once, then `iters` Gauss-Newton steps against the templates `tmpl`
    (from _lk_templates; its B axis matches guess's). With fidx (B,)
    int32, img_b holds a whole clip and pair b searches frame fidx[b].

    Returns (B, N, 2); with edges, also (B,) int64: the points of each
    pair whose iterate ended within 1 px of the +-(margin - 1) px it may
    wander from the incoming guess (the search ran out of room)."""
    w = 2 * radius + 1
    B = guess.shape[0]
    dev = guess.device
    t, ix, iy = tmpl["t"], tmpl["ix"], tmpl["iy"]
    gxx, gxy, gyy = tmpl["gxx"], tmpl["gxy"], tmpl["gyy"]
    det_safe, inv_ok = tmpl["det_safe"], tmpl["inv_ok"]
    pts_level = torch.as_tensor(pts_level, dtype=_F32, device=dev)
    if pts_level.dim() == 2:
        pts_level = pts_level[None].expand(B, *pts_level.shape)
    N = pts_level.shape[-2]

    # search region around the incoming guess: rows exact at the
    # integer anchor, the 256-column superset narrowed to the window's
    # Sc columns once, so the iterations read an (S, Sc) buffer
    M = margin
    S = w + 2 * M + 2
    Sc = w + 2 * M + 1
    anchor = torch.floor(pts_level + guess)
    origin = anchor - (radius + M)
    oy = origin[..., 1].to(torch.int32)
    ox = origin[..., 0].to(torch.int32)
    if strip_path_ok(img_b, N) and S <= STRIP_ROWS - 8:
        # strip fetch: top row quantized down to 8, strip clamped in
        # bounds (fine levels carry STRIP_PAD edge-replicated bottom
        # rows); the row residual rides the sampling taps. roff/rem go
        # negative for windows over the top/left edge, and _tap2's
        # clamp edge-replicates them like the per-row-clamped gather.
        Hp = img_b.shape[1]
        NB = img_b.shape[2] // LANE
        oyq = torch.clamp(torch.div(oy, 8, rounding_mode="floor"), 0, (Hp - STRIP_ROWS) // 8)
        obx = torch.clamp(torch.div(ox, LANE, rounding_mode="floor"), 0, NB - 2)
        roff = torch.clamp((oy - oyq * 8).to(_F32), max=float(STRIP_ROWS - S))
        rem = torch.clamp((ox - obx * LANE).to(_F32), max=float(2 * LANE - Sc))
        wide = gather_strips(img_b, oyq, obx, fidx)  # (B, N, 40, 256)
    else:
        # clamp the block (not the remainder): negative rem positions
        # edge-replicate through the clamped taps, as in the strip route
        NB_l = img_b.shape[2] // LANE
        obx = torch.clamp(torch.div(ox, LANE, rounding_mode="floor"), 0, max(NB_l - 2, 0))
        rem = (ox - obx * LANE).to(_F32)  # integer-valued
        roff = torch.zeros_like(rem)
        wide = gather_blocks(img_b, oy, obx, S, fidx)  # (B, N, S, 256)
    # the narrowing select: columns clamp(rem + j) of the region. rem is
    # integral, so rssync_tpu's one-hot tap matmul picks exactly these
    cols = torch.clamp(rem.to(torch.int64)[..., None]
                       + torch.arange(Sc, device=dev), 0, 2 * LANE - 1)
    rows = wide.shape[2]
    buf = torch.gather(wide, 3, cols[:, :, None, :].expand(B, N, rows, Sc)).to(_F32)
    g_frac = (pts_level + guess) - anchor  # (B, N, 2)

    d_rel = torch.zeros_like(guess)
    for _ in range(iters):
        # window rows roff + M + zy + [0, w), columns M + zx + [0, w)
        z = torch.clamp(g_frac + d_rel, -(M - 1.0), M - 1.0)
        patch_b = _sample_windows(buf, roff + M + z[..., 1], M + z[..., 0], w, w)
        e = patch_b - t
        bx = torch.sum(ix * e, dim=(-2, -1))
        by = torch.sum(iy * e, dim=(-2, -1))
        du = (gyy * bx - gxy * by) / det_safe
        dv = (gxx * by - gxy * bx) / det_safe
        step = torch.stack([du, dv], dim=-1)
        step = torch.where(inv_ok[..., None], step, torch.zeros_like(step))
        d_rel = torch.clamp(d_rel - step, -(M - 1.0), M - 1.0)
    if edges:
        at_edge = torch.amax(torch.abs(d_rel), dim=-1) > M - 2.0
        return guess + d_rel, torch.sum(at_edge, dim=-1)
    return guess + d_rel


# ---------------------------------------------------------------------------
# coarse stage: global SAD shift + local cost volume


def _windows(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Every shifted (h, w) window of x (..., h + 2D, w + 2D), as a view
    (..., 2D+1, 2D+1, h, w): [..., dy, dx, :, :] = x[..., dy : dy + h,
    dx : dx + w]. One view in place of a slice a shift: the shifted
    differences then take one launch, not one a shift."""
    return x.unfold(-2, h, 1).unfold(-2, w, 1)


def _global_shift(a: torch.Tensor, b: torch.Tensor, D: int) -> torch.Tensor:
    """Integer global translation per pair by full-image SAD argmin over
    (2D+1)^2 shifts. a, b: (B, h, w) float32. Returns (B, 2) float32 xy
    flow (b ~ a shifted BY the flow)."""
    B, h, w = a.shape
    K = 2 * D + 1
    # (B, K, K, h, w); shift (dy, dx) tests flow (dx - D, dy - D)
    diff = torch.abs(a[:, None, None] - _windows(_edge_pad(b, D, D, D, D), h, w))
    best = torch.argmin(torch.mean(diff, dim=(-2, -1)).reshape(B, K * K), dim=-1)
    gy = torch.div(best, K, rounding_mode="floor") - D
    gx = best % K - D
    return torch.stack([gx, gy], dim=-1).to(_F32)


def _coarse_init(pairs: dict, lvl_vol: int, lvl_glob: int, pts,
                 D_glob: int, glob_hw: tuple[int, int] | None = None) -> torch.Tensor:
    """Per-point flow init (level-0 px) from the coarse stage.

    pairs: {level: (a, b)} of (B, h, w) level images (u8 or float) for
    the two coarse levels. pts: (N, 2) level-0 xy (numpy or tensor).
    glob_hw: the global level's own (h, w) when its images carry
    storage padding; the global shift then compares only those pixels
    (`_lk_core` passes it in the deep plan).

    Spans: `coarse.global` (the global shift) and `coarse.volume` (the
    cost volume and the sample at the points). Returns (B, N, 2)
    float32."""
    a_g, b_g = pairs[lvl_glob]
    if glob_hw is not None:
        a_g, b_g = a_g[:, : glob_hw[0], : glob_hw[1]], b_g[:, : glob_hw[0], : glob_hw[1]]
    with span("coarse.global"):
        g = _global_shift(a_g.to(_F32), b_g.to(_F32), D_glob)  # (B, 2) at lvl_glob
    with span("coarse.volume"):
        return _volume_flow(pairs[lvl_vol], g, lvl_vol, lvl_glob, pts, D_glob)


def _volume_flow(pair: tuple, g: torch.Tensor, lvl_vol: int, lvl_glob: int, pts,
                 D_glob: int) -> torch.Tensor:
    """`_coarse_init`'s cost volume at lvl_vol around the global shift g
    (B, 2) at lvl_glob, sampled at pts: (B, N, 2) level-0 px."""
    a, b = pair
    B, h, w = a.shape
    dev = a.device
    scale_gl = float(2 ** (lvl_glob - lvl_vol))
    gi = torch.round(g * scale_gl).to(torch.int64)  # (B, 2) at lvl_vol
    ms = int(D_glob * scale_gl)

    # un-shift b by the global flow: value at (y, x) <- b[y + gy, x + gx]
    pb = _edge_pad(b, ms, ms, ms, ms)
    rows = ms + gi[:, 1:2] + torch.arange(h, device=dev)  # (B, h)
    cols = ms + gi[:, 0:1] + torch.arange(w, device=dev)  # (B, w)
    b0 = pb[torch.arange(B, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]

    # SAD cost volume over +-D with a (2*VOL_BOX+1)^2 box filter; u8
    # pixels run it in int16, exact (5x5 sums of |diff| <= 6375)
    if a.dtype.is_floating_point:
        av, b0v = a.to(_F32), b0.to(_F32)
    else:
        av, b0v = a.to(torch.int16), b0.to(torch.int16)
    D = VOL_D
    K = 2 * D + 1
    shifted = _windows(_edge_pad(b0v, D, D, D, D), h, w)  # (B, K, K, h, w)
    vol = torch.abs(av[:, None, None] - shifted).reshape(B, K * K, h, w)
    vp = _edge_pad(vol, VOL_BOX, VOL_BOX, VOL_BOX, VOL_BOX)
    r = sum(vp[:, :, i : i + h, :] for i in range(2 * VOL_BOX + 1))
    cost = sum(r[:, :, :, i : i + w] for i in range(2 * VOL_BOX + 1))
    best = torch.argmin(cost, dim=1)  # (B, h, w) in [0, K*K), first minimum
    # clamp the argmin one cell into the interior so the parabola's
    # neighbours exist, then read the 5-point stencil
    by = torch.clamp(torch.div(best, K, rounding_mode="floor"), 1, K - 2)
    bx = torch.clamp(best % K, 1, K - 2)
    j0 = by * K + bx

    def at(off):
        return torch.gather(cost, 1, (j0 + off)[:, None]).squeeze(1).to(_F32)

    c0 = at(0)

    def parab(cm, cp):
        denom = cm - 2.0 * c0 + cp
        big = torch.abs(denom) > 1e-9
        safe = torch.where(big, denom, torch.ones_like(denom))
        sub = torch.where(big, 0.5 * (cm - cp) / safe, torch.zeros_like(denom))
        return torch.clamp(sub, -0.6, 0.6)

    sx = parab(at(-1), at(1))
    sy = parab(at(-K), at(K))
    flow = torch.stack([bx.to(_F32) - D + sx, by.to(_F32) - D + sy], dim=-1)
    flow = flow + gi[:, None, None, :].to(_F32)  # (B, h, w, 2) at lvl_vol

    # bilinear sample of the flow at the grid points by one matmul
    scale = float(2**lvl_vol)
    p = torch.as_tensor(pts, dtype=_F32, device=dev) / scale
    px = torch.clamp(p[:, 0], 0.0, w - 1.001)
    py = torch.clamp(p[:, 1], 0.0, h - 1.001)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = (px - x0)[:, None]
    fy = (py - y0)[:, None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    q = torch.arange(h * w, device=dev)[None, :]

    def oh(yi, xi):
        return (q == (yi * w + xi)[:, None]).to(_F32)

    Wmat = (
        oh(y0i, x0i) * (1 - fx) * (1 - fy)
        + oh(y0i, x0i + 1) * fx * (1 - fy)
        + oh(y0i + 1, x0i) * (1 - fx) * fy
        + oh(y0i + 1, x0i + 1) * fx * fy
    )  # (N, h*w)
    sampled = torch.matmul(Wmat, flow.reshape(B, h * w, 2))  # (B, N, 2)
    return sampled * scale  # level-0 px


# ---------------------------------------------------------------------------
# tracker core


def _fine_plan(levels: int, iters: int, radius: int) -> list[tuple[int, int, int, int]]:
    """[(level, iters, margin, radius)] finest last. The entry level gets
    the wide margin, the finest level the most iterations. Deep pyramids
    (>= 7 levels, frames of ~1500 px and up) skip the intermediate level
    and enter with a small window; small frames keep 3 levels."""
    n_fine = min(3, levels)
    if n_fine >= 3 and levels >= DEEP_LEVELS:
        return [
            (2, 2, MARGIN_ENTRY, min(radius, 6)),
            (0, min(iters, 4), MARGIN_FINE + 1, radius),
        ]
    if n_fine >= 3:
        return [
            (2, 3, MARGIN_ENTRY, radius),
            (1, 2, MARGIN_FINE, radius),
            (0, min(iters, 5), MARGIN_FINE, radius),
        ]
    if n_fine == 2:
        return [
            (1, 3, MARGIN_ENTRY, radius),
            (0, min(iters, 5), MARGIN_FINE, radius),
        ]
    return [(0, min(iters, 8), MARGIN_ENTRY, radius)]


def _coarse_levels(levels: int, iters: int, radius: int) -> tuple[int, int] | None:
    """The coarse stage's (volume, global) levels, or None where the plan
    has no coarse stage: the pyramid reaches no further than the level
    below the fine plan's entry level."""
    entry = _fine_plan(levels, iters, radius)[0][0]
    if levels <= entry + 1:
        return None
    lvl_glob = levels - 1
    return max(entry + 1, lvl_glob - 2), lvl_glob


@dataclass(eq=False)
class _BlockState:
    """A block through its stages (`_block_stages`): the inputs, then
    each stage's result. hw, level0, edges: `_lk_core`'s logical_hw,
    level0 and edges; stack: the block's storage-padded (T, H, W)
    frames, None where the pairs are given; pairs: {level: (img_a,
    img_b)}; d: the coarse stage's (B, N, 2) level-0 px; out: the LK
    levels' positions (`_lk_core`'s return)."""

    grid: GridForms
    levels: int
    radius: int
    iters: int
    hw: tuple[int, int] | None
    stack: torch.Tensor | None = None
    pairs: dict | None = None
    level0: tuple | None = None
    edges: bool = False
    d: torch.Tensor | None = None
    out: object = None


def _pyramid_stage(b: _BlockState) -> None:
    """One pyramid per frame of the stack, as the {level: (img_a, img_b)}
    pairs of its consecutive frames."""
    need, plan, _ = _level_plan(b.levels, b.iters, b.radius)
    pyr = build_pyramid_sparse(b.stack, b.levels, need, b.hw, plan)
    b.pairs = {l: (pyr[l][:-1], pyr[l][1:]) for l in need}


def _coarse_stage(b: _BlockState) -> None:
    """`_coarse_init` at the plan's volume and global levels: d."""
    lvl_vol, lvl_glob = _coarse_levels(b.levels, b.iters, b.radius)
    pairs = {lvl: b.pairs[lvl] for lvl in {lvl_glob, lvl_vol}}
    hg = b.pairs[lvl_glob][0].shape[-2:]
    D_glob = max(2, min(hg) // 3)
    glob_hw = None
    if b.hw is not None and b.levels >= DEEP_LEVELS:
        glob_hw = tuple(_lvl_size(n, 0, lvl_glob) for n in b.hw)
    b.d = _coarse_init(pairs, lvl_vol, lvl_glob, b.grid.pts, D_glob, glob_hw)


def _lk_stage(b: _BlockState) -> None:
    """The LK levels from d, or from zero motion where it is None: out."""
    plan = _fine_plan(b.levels, b.iters, b.radius)
    entry = plan[0][0]
    d = b.d
    if d is None:
        ref = b.level0[2] if b.level0 is not None else b.pairs[entry][0]
        d = torch.zeros((ref.shape[0], *b.grid.pts.shape), dtype=_F32, device=ref.device)
    edge = None
    for lvl, it_l, m_l, r_l in plan:
        want_edge = b.edges and lvl == entry
        pts_l, index = b.grid.levels[lvl]
        if lvl == 0 and b.level0 is not None:
            clip, tmpl, fidx = b.level0
            out = _lk_iterate(clip, pts_l, d, tmpl, r_l, it_l, m_l, fidx=fidx, edges=want_edge)
            d, edge = out if want_edge else (out, edge)
            continue
        scale = float(2**lvl)
        out = _lk_level(b.pairs[lvl][0], b.pairs[lvl][1], pts_l, d / scale, r_l, it_l,
                        m_l, edges=want_edge, index=index)
        d, edge = out if want_edge else (out, edge)
        d = d * scale
    pos = b.grid.pts[None] + d
    b.out = (pos, edge) if b.edges else pos


def _block_stages(levels: int, iters: int, radius: int) -> list:
    """A block's (span, stage) in order, each stage a function of its
    `_BlockState`: the pyramid, the coarse stage where the plan has one,
    the LK levels. The eager block runs them (`_run_stages`), a
    `_BlockGraph` captures them."""
    coarse = [("track.coarse", _coarse_stage)] if _coarse_levels(levels, iters, radius) else []
    return [("track.pyramid", _pyramid_stage), *coarse, ("track.lk", _lk_stage)]


def _run_stages(b: _BlockState, stages: list):
    """Run stages on b eagerly, each in its span; returns b.out."""
    for name, stage in stages:
        with span(name):
            stage(b)
    return b.out


def _lk_core(pyr_pairs: dict, grid: "GridForms", levels: int, radius: int, iters: int,
             level0: tuple | None = None, logical_hw: tuple[int, int] | None = None,
             edges: bool = False):
    """Tracker body over per-level (img_a, img_b) batches, keyed by level
    (only the levels of `_needed_levels` exist): the block's stages after
    the pyramid (`_block_stages`: spans `track.coarse`, `track.lk`).
    grid: the points' `GridForms`.
    level0: (clip, templates, fidx): level 0 then searches the whole
    storage-padded clip at per-pair frame indices against templates
    made beforehand (the hybrid structure), and pyr_pairs needs no level
    0. logical_hw: the level-0 (H, W) the levels were built from. In the
    deep plan the global shift then compares the coarsest level's own
    pixels only: at 2704x2028 that level is 16 x 21 px stored 16 x 128,
    and over the 107 columns of edge padding the SAD picked shifts a
    level-7 px or more off under 30 fps motion, out of the cost volume's
    reach. The smaller plans keep rssync_tpu's SAD over the stored level.
    Returns (B, N, 2) positions; with edges, also the entry level's (B,)
    edge counts (`_lk_iterate`)."""
    b = _BlockState(grid, levels, radius, iters, logical_hw, pairs=pyr_pairs, level0=level0,
                    edges=edges)
    return _run_stages(b, _block_stages(levels, iters, radius)[1:])


def _level_plan(levels: int, iters: int, radius: int):
    """(needed levels, {level: storage kind}, level 0 is a fine level)."""
    need = _needed_levels(levels, iters, radius)
    fine = {l for l, *_ in _fine_plan(levels, iters, radius)}
    return need, {l: "fine" if l in fine else "lane" for l in need}, 0 in fine


def _lk_pairs_core(imgs_a, imgs_b, pts, levels: int, radius: int, iters: int) -> torch.Tensor:
    """Track pts from imgs_a[i] to imgs_b[i]: (B, H, W) x2 -> (B, N, 2)."""
    need, plan, fine0 = _level_plan(levels, iters, radius)
    hw = tuple(imgs_a.shape[-2:])
    grid = grid_forms(pts, hw, levels, radius, iters, imgs_a.device)
    with span("track.pyramid"):
        pyr_a = build_pyramid_sparse(_pad_lanes(imgs_a, fine0), levels, need, hw, plan)
        pyr_b = build_pyramid_sparse(_pad_lanes(imgs_b, fine0), levels, need, hw, plan)
    return _lk_core({l: (pyr_a[l], pyr_b[l]) for l in need}, grid, levels, radius, iters,
                    logical_hw=hw)


def _lk_video_core(frames, grid: "GridForms", levels: int, radius: int, iters: int,
                   logical_hw: tuple[int, int] | None = None, edges: bool = False):
    """Track consecutive pairs of a frame block with one pyramid per
    frame (each interior frame serves two pairs; span `track.pyramid`).
    logical_hw: the unpadded (H, W) when `frames` already carry the
    level-0 storage padding; otherwise frames are padded here. edges:
    as `_lk_core`."""
    if logical_hw is None:
        logical_hw = tuple(frames.shape[-2:])
        frames = _pad_lanes(frames, _level_plan(levels, iters, radius)[2])
    b = _BlockState(grid, levels, radius, iters, logical_hw, stack=frames, edges=edges)
    return _run_stages(b, _block_stages(levels, iters, radius))


def _check_prepadded(frames, logical_hw, levels, radius, iters) -> None:
    fine0 = _level_plan(levels, iters, radius)[2]
    exp = _stored_dims(*logical_hw, "fine" if fine0 else "lane")
    if tuple(frames.shape[1:3]) != exp:
        raise ValueError(
            f"pre-padded frames {tuple(frames.shape[1:3])} != expected {exp} "
            f"for logical {tuple(logical_hw)}"
        )


def _host_grid(pts, width: int, height: int, grid_step: int | None) -> np.ndarray:
    """The (N, 2) float32 host point set of the video entry points."""
    if pts is None:
        pts = grid_points(width, height, grid_step or auto_grid_step(width))
    if isinstance(pts, torch.Tensor):
        pts = pts.detach().cpu().numpy()
    return np.asarray(pts, np.float32)


@dataclass(eq=False)
class GridForms:
    """A point set with the device forms the tracker reads, made once a
    call (`grid_forms`) so a block copies nothing from the host.

    grid: the points as given (an (N, 2) host array: emission's
    rolling-shutter times read it). pts: (N, 2) float32 on the device.
    levels: {fine level: (pts / 2**level, (N, 2) float32 on the device;
    its templates' `_patch_index`, None off the static-template route)}.
    key: the host grid's bytes, (H, W) and the plan, which the block
    graphs are cached under (None for points given on the device).
    `rays(lens)` lifts the grid once a lens."""

    grid: object
    pts: torch.Tensor
    levels: dict
    key: tuple | None
    _rays: tuple | None = None

    def rays(self, lens: lens_ops.Lens) -> np.ndarray:
        """(N, 3) float64 host rays of the grid under `lens`, lifted and
        read once (spans `emit.lift`, `emit.read`)."""
        if self._rays is None or self._rays[0] != lens:
            self._rays = (lens, _lift_grid(lens, self.pts))
        return self._rays[1]


def grid_forms(pts, hw: tuple[int, int], levels: int, radius: int, iters: int,
               device) -> GridForms:
    """`GridForms` of pts at the plan of (H, W) frames. An (N, 2) host
    array is uploaded once a form: its per-level points are divided on
    the host, and a level where they are whole numbers takes the
    static-template route with its index made here, for the level's
    storage dims. Points given as a tensor stay on the dynamic route,
    divided on the device."""
    plan = _fine_plan(levels, iters, radius)
    if isinstance(pts, torch.Tensor):
        p = torch.as_tensor(pts, dtype=_F32, device=device)
        return GridForms(pts, p, {lvl: (p / float(2**lvl), None) for lvl, *_ in plan}, None)
    host = np.asarray(pts, np.float32)
    kinds = _level_plan(levels, iters, radius)[1]
    at = {}
    for lvl, _it, _m, r_l in plan:
        p = host / float(2**lvl)
        index = None
        if bool(np.all(p == np.round(p))):
            dims = _stored_dims(_lvl_size(hw[0], 0, lvl), _lvl_size(hw[1], 0, lvl), kinds[lvl])
            index = _patch_index(p - (r_l + 1), 2 * r_l + 3, dims, device)
        at[lvl] = (torch.as_tensor(p, dtype=_F32, device=device), index)
    key = (host.tobytes(), host.shape, tuple(hw), levels, radius, iters)
    return GridForms(pts, torch.as_tensor(host, device=device), at, key)


# ---------------------------------------------------------------------------
# public API


def lk_track(img_a: torch.Tensor, img_b: torch.Tensor, pts, levels: int | None = None,
             radius: int = LK_RADIUS, iters: int = LK_ITERS) -> torch.Tensor:
    """Track points pts (N, 2) xy from img_a to img_b (H, W). Returns the
    tracked (N, 2) positions in img_b; levels=None scales the pyramid
    depth with the image size."""
    if levels is None:
        levels = auto_levels(img_a.shape[0], img_a.shape[1])
    return lk_track_pairs(img_a[None], img_b[None], pts, levels, radius, iters)[0]


def lk_track_pairs(imgs_a: torch.Tensor, imgs_b: torch.Tensor, pts,
                   levels: int | None = None, radius: int = LK_RADIUS,
                   iters: int = LK_ITERS) -> torch.Tensor:
    """Tracking of independent pairs: (B, H, W) x2 -> (B, N, 2)."""
    if levels is None:
        levels = auto_levels(imgs_a.shape[1], imgs_a.shape[2])
    p = torch.as_tensor(pts, dtype=_F32, device=imgs_a.device)
    return _lk_pairs_core(imgs_a, imgs_b, p, levels, radius, iters)


def lk_track_video(frames: torch.Tensor, pts=None, levels: int | None = None,
                   radius: int = LK_RADIUS, iters: int = LK_ITERS,
                   grid_step: int | None = None,
                   logical_hw: tuple[int, int] | None = None, edges: bool = False):
    """Track one point set across all consecutive pairs of a frame block:
    (T, H, W) -> (T-1, N, 2), eagerly. pts=None takes the reference grid
    (grid_step, by default from the width); pts may also be the
    `GridForms` of the grid at these frames' plan (`grid_forms`), which
    are otherwise made here. logical_hw: the unpadded (H, W) when frames
    are pre-padded (pad_frames_host). With edges, returns (tracks, (T-1,)
    int64 counts of each pair's points whose entry-level LK iterate ended
    within 1 px of its margin), the counts left on the device."""
    H, W = logical_hw if logical_hw is not None else frames.shape[1:3]
    if levels is None:
        levels = auto_levels(H, W)
    if logical_hw is not None:
        _check_prepadded(frames, logical_hw, levels, radius, iters)
    if not isinstance(pts, GridForms):
        pts = grid_forms(_host_grid(pts, W, H, grid_step), (H, W), levels, radius, iters,
                         frames.device)
    return _lk_video_core(frames, pts, levels, radius, iters, logical_hw=logical_hw,
                          edges=edges)


def lk_track_video_chunked(frames: torch.Tensor, pts=None, chunk: int = 16,
                           levels: int | None = None, radius: int = LK_RADIUS,
                           iters: int = LK_ITERS, grid_step: int | None = None,
                           logical_hw: tuple[int, int] | None = None,
                           hybrid: bool | None = None) -> torch.Tensor:
    """Track (T, H, W) consecutive frames -> (T-1, N, 2) in blocks of
    `chunk` pairs (chunk + 1 frames each, consecutive blocks sharing a
    frame). Requires (T-1) % chunk == 0: callers pad by repeating the
    last frame, which tracks to zero flow. logical_hw: the unpadded
    (H, W) when frames carry the level-0 storage padding
    (pad_frames_host); the level-0 pad then never runs on the device.

    hybrid: the per-frame passes (the small pyramid levels and the
    level-0 templates) run once over the whole clip, each block slices
    them, and level 0 fetches its search strips from the whole clip at
    per-pair frame indices (`_lk_iterate(fidx=)`), so no full-size
    block is sliced. Off by default, as in rssync_tpu (measured slower
    there, tracking.py:1196-1208). Where the level-0 plan cannot serve
    it (level 0 not a fine level or not the last one, no strip route,
    non-integer points) the block structure runs, as in rssync_tpu."""
    H, W = logical_hw if logical_hw is not None else frames.shape[1:3]
    if levels is None:
        levels = auto_levels(H, W)
    T = frames.shape[0]
    if (T - 1) % chunk:
        raise ValueError(f"(T-1)={T - 1} must be a multiple of chunk={chunk}")
    pts = _host_grid(pts, W, H, grid_step)
    if logical_hw is None:
        frames = _pad_lanes(frames, _level_plan(levels, iters, radius)[2])
    else:
        _check_prepadded(frames, logical_hw, levels, radius, iters)
    grid = grid_forms(pts, (H, W), levels, radius, iters, frames.device)
    need, pad_plan, fine0 = _level_plan(levels, iters, radius)
    plan = _fine_plan(levels, iters, radius)
    if (hybrid and fine0 and plan[-1][0] == 0 and strip_path_ok(frames, len(pts))
            and grid.levels[0][1] is not None):
        small = [lvl for lvl in need if lvl > 0]
        pyr = build_pyramid_sparse(frames, levels, small, (H, W), pad_plan)
        pts0, index0 = grid.levels[0]
        tmpl0 = _lk_templates(frames, pts0, plan[-1][3], index0)
        outs = []
        for s in range(0, T - 1, chunk):
            pairs = {lvl: (pyr[lvl][s : s + chunk], pyr[lvl][s + 1 : s + chunk + 1])
                     for lvl in small}
            tmpl = {k: v[s : s + chunk] for k, v in tmpl0.items()}
            fidx = torch.arange(s + 1, s + 1 + chunk, dtype=torch.int32, device=frames.device)
            outs.append(_lk_core(pairs, grid, levels, radius, iters, (frames, tmpl, fidx),
                                 logical_hw=(H, W)))
    else:
        outs = [
            _lk_video_core(frames[s : s + chunk + 1], grid, levels, radius, iters,
                           logical_hw=(H, W))
            for s in range(0, T - 1, chunk)
        ]
    return torch.cat(outs) if outs else torch.zeros((0, *pts.shape), dtype=_F32,
                                                    device=frames.device)


# ---------------------------------------------------------------------------
# undistort + rolling-shutter timestamps + ray lifting


def lift_rays(lens: lens_ops.Lens, pts_a: torch.Tensor, pts_b: torch.Tensor):
    """Undistort both endpoints and lift them to unit rays
    normalize([x, y, 1]) (ref: core_testcode.cpp:147-152), on the
    points' device (`lens_ops.lift_points`, one kernel a call on a card)."""
    return lens_ops.lift_points(lens, pts_a), lens_ops.lift_points(lens, pts_b)


def rolling_shutter_ts(lens: lens_ops.Lens, pts_a: np.ndarray, pts_b: np.ndarray,
                       ts_frame_a: float, ts_frame_b: float, rows: int):
    """Per-ray rolling-shutter timestamps from each endpoint's own row,
    the tracked row for frame B included (ref: core_testcode.cpp:
    144-145). Host f64: frame timestamps are minutes-scale and must keep
    sub-us resolution."""
    ts_a = ts_frame_a + lens.ro * (np.asarray(pts_a, np.float64)[:, 1] / rows)
    ts_b = ts_frame_b + lens.ro * (np.asarray(pts_b, np.float64)[:, 1] / rows)
    return ts_a, ts_b


def _f64(x: torch.Tensor) -> np.ndarray:
    return x.detach().to(torch.float64).cpu().numpy()


def _lift_grid(lens: lens_ops.Lens, pts_t: torch.Tensor) -> np.ndarray:
    """The grid's (N, 3) float64 host rays from its (N, 2) float32
    device points: the lift enqueued (span `emit.lift`), then read
    (span `emit.read`, count `host_reads`)."""
    with span("emit.lift"):
        lifted = lens_ops.lift_points(lens, pts_t)
    with span("emit.read"):
        count("host_reads")
        return _f64(lifted)


def emit_track_result(problem, lens: lens_ops.Lens, pts: np.ndarray,
                      pts_t: torch.Tensor, height: int, frame_idx: int, tracked,
                      ts_cur: float, ts_nxt: float) -> None:
    """Feed one frame pair's tracked grid into `problem`: lift both
    endpoints to unit rays, apply rolling-shutter timestamps, call
    `set_track_result` (ref: core_testcode.cpp:140-157). pts: the (N, 2)
    host grid; pts_t: the same as a float32 tensor on the tracker's
    device, where the pair is lifted; tracked: (N, 2) positions in the
    next frame. A one-pair `emit_track_block`."""
    tracked_t = torch.as_tensor(tracked, dtype=_F32, device=pts_t.device)
    emit_track_block(problem, lens, pts, tracked_t[None], [frame_idx], [ts_cur, ts_nxt],
                     height)


def emit_track_block(problem, lens: lens_ops.Lens, pts: np.ndarray,
                     tracked: torch.Tensor, frame_idx, frame_ts, height: int,
                     edge_points: torch.Tensor | None = None) -> int | None:
    """Feed a block of P consecutive pairs into `problem`: the grid's
    rays are lifted once, the tracked endpoints of all pairs in one call
    (undistortion is elementwise, so each pair's rays equal
    `emit_track_result`'s). pts: the (N, 2) host grid, or its
    `GridForms`, whose rays (`GridForms.rays`, lifted once a lens) are
    then not lifted again. tracked: (P, N, 2) positions in frames
    frame_idx[i] + 1; frame_idx: (P,) index of each pair's first frame;
    frame_ts: (P + 1,) seconds of the P + 1 frames. edge_points: the
    pairs' (P,) device counts of `lk_track_video(edges=True)`, read in
    the one transfer of the tracked points; returns their sum (None
    without them).

    Spans: `emit.lift` around each lift as enqueued (count
    `lift_launches`, one a kernel launch: none on the CPU), `emit.read`
    around the host reads (each waits for the card; the grid's, where
    it is lifted here, then the tracked points' two), `emit.set` around
    the host intake, all inside `track.emit`."""
    P, N = tracked.shape[:2]
    with span("track.emit"):
        if isinstance(pts, GridForms):
            rays_a, pts = pts.rays(lens), pts.grid
        else:
            rays_a = _lift_grid(lens, torch.as_tensor(pts, dtype=_F32, device=tracked.device))
        with span("emit.lift"):
            lifted_b = lens_ops.lift_points(lens, tracked.reshape(-1, 2).to(_F32))
        with span("emit.read"):
            count("host_reads", 2)
            rays_b = _f64(lifted_b).reshape(P, N, 3)
            n_edge = None
            if edge_points is None:
                tracked_np = tracked.detach().cpu().numpy()
            else:  # counts < 2^24 ride exactly as float32 behind the points
                flat = torch.cat([tracked.detach().reshape(-1).to(_F32),
                                  edge_points.to(_F32)]).cpu().numpy()
                tracked_np = flat[: P * N * 2].reshape(P, N, 2)
                n_edge = int(flat[P * N * 2 :].sum())
        with span("emit.set"):
            for i in range(P):
                ts_a, ts_b = rolling_shutter_ts(
                    lens, pts, tracked_np[i], frame_ts[i], frame_ts[i + 1], height)
                problem.set_track_result(int(frame_idx[i]), ts_a, ts_b, rays_a, rays_b[i])
    return n_edge


#: the tracker block's graphs, one for each grid and block shape
_BLOCK_GRAPHS = GraphCache()


def _use_block_graph(stack: torch.Tensor) -> bool:
    """Whether `_track_blocks` replays a captured block: on a CUDA device."""
    return stack.is_cuda


class _BlockGraph:
    """A tracker block (`_lk_video_core` with edge counts, at the default
    radius and iterations) captured as one CUDA graph a stage
    (`_block_stages`), in order, into one memory pool, over a static
    stack and the grid's forms of the call that made it. A replay runs
    the same kernels in the same order on the same values as the eager
    block, so its tracks and counts are bit-equal."""

    def __init__(self, stack: torch.Tensor, grid: GridForms, hw: tuple[int, int],
                 levels: int):
        need, plan, _ = _level_plan(levels, LK_ITERS, LK_RADIUS)
        # the graphs read the pyramid's weights: held as long as they are
        self.weights = _pyramid_weights(stack.shape[-2:], hw, need, plan, stack.device)
        self.block = _BlockState(grid, levels, LK_RADIUS, LK_ITERS, hw,
                                 stack=torch.empty_like(stack), edges=True)
        self.stages = _block_stages(levels, LK_ITERS, LK_RADIUS)
        self.graphs: list = []
        #: the shapes of K3's launches in a replay (`captured_launches`)
        self.k3: list = []

    def capture(self) -> None:
        """Run the stages once eagerly, then capture each
        (`utils/graphs.capture`), with the K3 launches the graphs hold."""
        b = self.block

        def warmup():
            for _name, stage in self.stages:
                stage(b)
            b.pairs = b.d = b.out = None

        with captured_launches() as k3:
            self.graphs = capture_graphs(b.stack.device, warmup,
                                         [partial(stage, b) for _name, stage in self.stages])
        self.k3 = k3

    def replay(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Each stage's replay in its span (count `track.graph_replays`
        a replay); copies of the (B, N, 2) tracks and (B,) edge counts."""
        for (name, _stage), graph in zip(self.stages, self.graphs):
            count("track.graph_replays")
            with span(name):
                graph.replay()
        count_replay(self.k3)
        return tuple(x.clone() for x in self.block.out)


def _graphed_block(stack: torch.Tensor, grid: GridForms, hw: tuple[int, int],
                   levels: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`lk_track_video(stack, grid, logical_hw=hw, edges=True)` as a
    replay of the cached `_BlockGraph` for the stack's shape and the
    grid's key (captured first where there is none: count
    `track.graph_captures`, span `track.capture`)."""
    key = (grid.key, tuple(stack.shape), stack.dtype)
    with _BLOCK_GRAPHS.use(stack.device, key,
                           lambda: _BlockGraph(stack, grid, hw, levels)) as bg:
        bg.block.stack.copy_(stack)
        if not bg.graphs:
            count("track.graph_captures")
            with span("track.capture"):
                bg.capture()
        return bg.replay()


def _track_blocks(problem, lens: lens_ops.Lens, pts: np.ndarray, hw: tuple[int, int],
                  blocks: Iterator[tuple[torch.Tensor, Sequence, Sequence]],
                  device) -> None:
    """The block loop of `track_clip` and `track_frames`: track each
    block that `blocks` yields and feed its pairs to
    `problem.set_track_result`. A block is (stack, frame_idx, frame_ts):
    block + 1 storage-padded frames on `device`, the first frames of the
    P pairs it emits, and the P + 1 frames' seconds. pts: the (N, 2)
    host grid; hw: the unpadded (H, W).

    The grid's `GridForms` and rays are made once, before the first
    block: no block copies the grid from the host. On a CUDA device a
    block is a replay of the captured `_BlockGraph` for its shape
    (`_graphed_block`), which always counts the edge points; elsewhere
    `lk_track_video` runs it eagerly.

    Up to TRACK_DEPTH blocks stay in flight: `emit_track_block` drains
    the oldest before the next block is pulled, so a source may reuse a
    block's host buffer TRACK_DEPTH blocks later.

    Spans: `track.grid` the forms and the grid's rays (`emit.lift`,
    `emit.read`), then `track.block` one pull (the source's spans), its
    enqueue (`track.pyramid`, `track.coarse`, `track.lk`; on a card,
    counts `track.graph_replays` and, before a key's first replay,
    `track.capture` and count `track.graph_captures`) and one drain
    (`track.emit`; counts `pairs` and, while recording,
    `lk_edge_points`: the drained pairs' points whose entry-level LK
    iterate ended within 1 px of its margin). A block is drained
    TRACK_DEPTH - 1 `track.block`s after its own; once the source is
    spent, one a `track.block`."""
    levels = auto_levels(*hw)
    with span("track.grid"):
        grid = grid_forms(pts, hw, levels, LK_RADIUS, LK_ITERS, device)
        grid.rays(lens)
    pending: deque = deque()
    done = False
    while pending or not done:
        with span("track.block"):
            blk = None if done else next(blocks, None)
            done = blk is None
            if not done:
                stack, frame_idx, frame_ts = blk
                edges = recording_on()
                if _use_block_graph(stack):
                    _check_prepadded(stack, hw, levels, LK_RADIUS, LK_ITERS)
                    tracked, edge = _graphed_block(stack, grid, hw, levels)
                    out = (tracked, edge if edges else None)
                else:
                    out = lk_track_video(stack, grid, logical_hw=hw, edges=edges)
                    out = out if edges else (out, None)
                pending.append((frame_idx, frame_ts, *out))
            if pending and (done or len(pending) >= TRACK_DEPTH):
                frame_idx, frame_ts, tracked, edge = pending.popleft()
                n = len(frame_idx)
                count("pairs", n)
                args = (problem, lens, grid, tracked[:n], frame_idx, frame_ts, hw[0])
                if edge is None:
                    emit_track_block(*args)
                else:
                    count("lk_edge_points", emit_track_block(*args, edge_points=edge[:n]))


def track_clip(problem, lens: lens_ops.Lens, frames: torch.Tensor, frame_ts,
               ranges=None, grid_step: int | None = None,
               block: int = TRACK_BLOCK) -> None:
    """Track the frame pairs of `ranges` and feed
    `problem.set_track_result`: the tracking stage of `track_frames` for
    frames already on the device, with no video decode.

    frames: (T, H, W) uint8 clip on the tracker's device; frame_ts: (T,)
    seconds; ranges: (begin, end) pair ranges, end exclusive (pair p
    reads frames p and p + 1); None = every pair. Each range is cut into
    blocks of `block` pairs, sliced on the device and tracked by
    `_track_blocks`; a short tail block is filled up by repeating its
    last frame (those pairs are not emitted), so every block has the
    same shape.

    Spans: `_track_blocks`'s, with `track.slice` (a block's frames
    sliced and padded) the source's."""
    T, H, W = frames.shape
    if ranges is None:
        ranges = [(0, T - 1)]
    fine0 = _level_plan(auto_levels(H, W), LK_ITERS, LK_RADIUS)[2]
    frame_ts = np.asarray(frame_ts, np.float64)

    def slices():
        for pb, pe in ranges:
            pb, pe = max(0, int(pb)), min(T - 1, int(pe))
            for s in range(pb, pe, block):
                e = min(s + block, pe)  # pairs s .. e-1, frames s .. e
                with span("track.slice"):
                    idx = torch.clamp(torch.arange(s, s + block + 1, device=frames.device),
                                      max=e)
                    stack = _pad_lanes(frames.index_select(0, idx), fine0)
                yield stack, np.arange(s, e), frame_ts[s : e + 1]

    _track_blocks(problem, lens, grid_points(W, H, grid_step), (H, W), slices(), frames.device)


# ---------------------------------------------------------------------------
# host video decode


@dataclass
class Frame:
    index: int
    timestamp: float  # seconds
    gray: np.ndarray  # (H, W) uint8


def _probe_raw_luma(cv2, path: str, height: int) -> bool:
    """Check whether CONVERT_RGB=0 yields a usable luma plane for this
    stream (yuv420p-family): the ffmpeg backend then skips the YUV->BGR
    conversion and `read()` returns either the bare Y plane (H, W) or
    the full I420 buffer (H*3/2, W)."""
    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            return False
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
        ok, img = cap.read()
        return bool(
            ok
            and img is not None
            and img.ndim == 2
            and img.shape[0] in (height, height * 3 // 2)
        )
    finally:
        cap.release()


class VideoSource:
    """cv2-backed host decoder (the reference's VideoCapture usage,
    ref: core_testcode.cpp:99-122), with a raw-luma fast path: where
    the reference decodes to BGR and converts to gray
    (core_testcode.cpp:118-121), yuv420p streams here skip both
    conversions and read the Y plane directly."""

    #: forward gaps up to this many frames skip via grab() (decode
    #: without convert/copy) instead of a container seek. A seek costs a
    #: keyframe-to-position decode, which on sparse-keyframe streams
    #: (cv2's own mp4v writer emits very few) re-decodes up to the whole
    #: prefix per seek; grab() is a bounded decode per frame. 512 covers
    #: window-scoped gaps (<= syncpoint_distance).
    GRAB_FWD = 512

    def __init__(self, path: str, raw_luma: bool = True):
        import cv2

        try:  # silence ffmpeg's per-frame yuv420p->8UC1 notice
            cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_ERROR)
        except AttributeError:
            pass
        self._cv2 = cv2
        self.path = path
        probe = cv2.VideoCapture(path)
        if not probe.isOpened():
            raise RuntimeError("video open failed")
        self.fps = probe.get(cv2.CAP_PROP_FPS)
        self.width = int(probe.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(probe.get(cv2.CAP_PROP_FRAME_HEIGHT))
        probe.release()
        self._raw = raw_luma and _probe_raw_luma(cv2, path, self.height)
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise RuntimeError("video open failed")
        if self._raw:
            self.cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
        self._pos = 0  # next frame read() returns

    def close(self) -> None:
        self.cap.release()

    def _gray(self, img) -> np.ndarray:
        if self._raw:
            if img.shape[0] == self.height:
                return img.copy()
            return img[: self.height].copy()
        return self._cv2.cvtColor(img, self._cv2.COLOR_BGR2GRAY)

    def seek(self, frame: int) -> None:
        """Position so the next read() returns `frame`. No-op when
        already there; short forward gaps grab() through (see
        GRAB_FWD); otherwise a real container seek."""
        if frame == self._pos:
            return
        if self._pos < frame <= self._pos + self.GRAB_FWD:
            for _ in range(frame - self._pos):
                if not self.cap.grab():
                    raise RuntimeError("grab failed during forward skip")
            self._pos = frame
            return
        self.cap.set(self._cv2.CAP_PROP_POS_FRAMES, frame)
        if self.cap.get(self._cv2.CAP_PROP_POS_FRAMES) != frame:
            raise RuntimeError("Seek failed")
        self._pos = frame

    def frames(self, start: int, stop: int) -> Iterator[Frame]:
        self.seek(start)
        for idx in range(start, stop):
            ok, img = self.cap.read()
            if not ok:
                raise RuntimeError("frame read failed")
            self._pos = idx + 1
            ts = self.cap.get(self._cv2.CAP_PROP_POS_MSEC) / 1000.0
            yield Frame(index=idx, timestamp=ts, gray=self._gray(img))


class FrameFeed:
    """Decode-ahead frame feed: one reader thread decodes chunks of
    [start, stop) in order into a bounded buffer, so host decode
    overlaps device tracking instead of serializing with it (the
    reference decodes inline in its tracking loop,
    ref: core_testcode.cpp:99-122). At most AHEAD chunks are buffered
    beyond the consumer.

    rssync_tpu's FrameFeed (tracking.py:1493) with its defaults,
    n_workers=1 and ahead=16: its thread workers beyond one interleave
    chunk seeks, which re-decode from a keyframe per chunk on
    sparse-keyframe streams, and parallel decode is the DecodePool's
    job (decode_pool.py), so the port keeps the single reader only."""

    CHUNK = 32
    AHEAD = 16

    def __init__(self, path: str, start: int, stop: int):
        self._src = VideoSource(path)
        self.fps = self._src.fps
        self.width = self._src.width
        self.height = self._src.height
        bounds = list(range(start, stop, self.CHUNK)) + [stop]
        self._chunks = list(zip(bounds[:-1], bounds[1:]))
        self._results: dict[int, object] = {}
        self._next_emit = 0
        self._cv = threading.Condition(threading.Lock())
        self._stopped = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        ci = 0
        try:
            for ci, (c0, c1) in enumerate(self._chunks):
                with self._cv:
                    while ci >= self._next_emit + self.AHEAD and not self._stopped:
                        self._cv.wait(timeout=1.0)
                    if self._stopped:
                        return
                frames = list(self._src.frames(c0, c1))
                with self._cv:
                    self._results[ci] = frames
                    self._cv.notify_all()
        except Exception as e:  # surfaced in the consumer
            with self._cv:
                self._results[ci] = e
                self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    def __iter__(self) -> Iterator[Frame]:
        try:
            for ci in range(len(self._chunks)):
                with self._cv:
                    while ci not in self._results:
                        self._cv.wait(timeout=1.0)
                        if self._stopped and ci not in self._results:
                            return
                    item = self._results.pop(ci)
                    self._next_emit = ci + 1
                    self._cv.notify_all()
                if isinstance(item, Exception):
                    raise item
                yield from item
        finally:
            self.close()


def _range_feeds(video_path: str,
                 ranges: Sequence[tuple[int, int]]) -> Iterator[Iterator[Frame]]:
    """One frame iterator per PAIR range (decoding [pb, pe+1) each).

    Picks the decode backend by available parallelism: with >1 CPU a
    multiprocess DecodePool shards chunks across decoder processes; on a
    single core the decode-ahead FrameFeed thread (no spawn cost, still
    overlaps device tracking). Both yield bit-identical frames."""
    from rssync_tpu_torch.frontend.decode_pool import (
        PROBE_MIN_FRAMES,
        DecodePool,
        available_workers,
        probe_workers,
    )

    n = available_workers()
    if n <= 1 or len(ranges) == 0:
        for pb, pe in ranges:
            yield iter(FrameFeed(video_path, pb, pe + 1))
        return
    probe = VideoSource(video_path)
    raw, h, w = probe._raw, probe.height, probe.width
    probe.close()
    # replace the min(4, cores) guess with a measured-throughput choice
    # when enough frames are at stake to amortize the probe
    total = sum(pe + 1 - pb for pb, pe in ranges)
    if total >= PROBE_MIN_FRAMES:
        n = probe_workers(video_path, h, w, raw, total, start=ranges[0][0])
        if n <= 1:  # measured: parallel decode loses on this host
            for pb, pe in ranges:
                yield iter(FrameFeed(video_path, pb, pe + 1))
            return
    pool = DecodePool(video_path, [(pb, pe + 1) for pb, pe in ranges], h, w, raw, n)
    try:
        for i in range(len(ranges)):
            yield (Frame(index=idx, timestamp=ts, gray=g) for idx, ts, g in pool.span_frames(i))
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# the tracking stage of the recipe pipeline


#: pair ranges closer than this many frames merge into one decode run
#: (re-seeking costs a keyframe-to-position decode of up to a GOP)
RANGE_MERGE_GAP = 16


def _merge_pair_ranges(ranges, frame_begin: int, frame_end: int) -> list[tuple[int, int]]:
    """Clip (begin, end)-exclusive PAIR ranges to [frame_begin,
    frame_end), sort, and merge overlapping/near-adjacent ones."""
    clipped = sorted((max(frame_begin, int(b)), min(frame_end, int(e))) for b, e in ranges)
    out: list[list[int]] = []
    for b, e in clipped:
        if e <= b:
            continue
        if out and b <= out[-1][1] + RANGE_MERGE_GAP:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([b, e])
    return [(b, e) for b, e in out]


def track_frames(problem, lens: lens_ops.Lens, video_path: str, frame_begin: int,
                 frame_end: int, grid_step: int | None = None, method: str = "lk",
                 progress: bool = False, block: int = TRACK_BLOCK, ranges=None,
                 device="cuda") -> None:
    """Track every consecutive frame pair in [frame_begin, frame_end)
    and feed `problem.set_track_result` (ref: core_testcode.cpp:97-162).

    method: "lk" (the tracker on `device`: frames decode on the host in
    blocks of `block` pairs, are storage-padded there by
    `stack_pad_host`, a short tail block filled by repeating its last
    frame, uploaded as u8 from pinned memory and tracked by
    `_track_blocks`, the block loop of `track_clip`, so the tracks
    equal `track_clip`'s on the same frames bit for bit) or "dis" (host
    cv2 DIS dense flow sampled at the grid, the reference's tracker,
    for cross-validation; rays are lifted on `device`).

    ranges: optional (begin, end)-exclusive PAIR ranges restricting
    tracking to the pairs the engine will read; the pipeline passes the
    union of its syncpoint windows, so host decode skips inter-window
    frames. The reference decodes its whole frame_range inline
    (core_testcode.cpp:99-122) but equally never reads inter-window
    pairs, so recipe outputs are identical. None = every pair.

    rssync_tpu's XLA compile warm-up (the tracker-warm thread, its
    gate, and the staging of uploaded blocks while the tracker compiles,
    RSSYNC_TRACK_MAX_STAGED) is not ported: nothing here compiles at
    first call.

    Spans: `_track_blocks`'s, with the source's `track.decode_wait`
    (the next frames from the decoder), `track.stack` (the host pad)
    and `track.upload` (the copy to `device`, enqueued).
    """
    dev = torch.device(device)
    if ranges is None:
        ranges = [(frame_begin, frame_end)]
    ranges = _merge_pair_ranges(ranges, frame_begin, frame_end)
    probe = VideoSource(video_path)
    width, height = probe.width, probe.height
    probe.close()
    pts = grid_points(width, height, grid_step)

    if method == "dis":
        import cv2

        dis = cv2.DISOpticalFlow.create()
        src = VideoSource(video_path)
        pts_t = torch.as_tensor(pts, dtype=_F32, device=dev)
        ij = pts.astype(int)
        for pb, pe in ranges:
            it = src.frames(pb, pe + 1)
            cur = next(it)
            for nxt in it:
                if progress:
                    print(f"processing frame {cur.index}", flush=True)
                flow = dis.calc(cur.gray, nxt.gray, None)
                tracked = pts + flow[ij[:, 1], ij[:, 0]]
                emit_track_result(problem, lens, pts, pts_t, height, cur.index, tracked,
                                  cur.timestamp, nxt.timestamp)
                cur = nxt
        src.close()
        return
    if method != "lk":
        raise ValueError(f"unknown tracking method {method!r}")

    fine0 = _level_plan(auto_levels(height, width), LK_ITERS, LK_RADIUS)[2]
    Hp, Wp = _stored_dims(height, width, "fine" if fine0 else "lane")
    # one host buffer per block in flight: `_track_blocks` pulls a block
    # only after the block that last used its buffer was drained, so that
    # block's upload has finished
    pinned = dev.type == "cuda"
    bufs = itertools.cycle([
        torch.empty((block + 1, Hp, Wp), dtype=torch.uint8, pin_memory=pinned).numpy()
        for _ in range(TRACK_DEPTH)])

    def uploads():
        for it in _range_feeds(video_path, ranges):
            carry: list[Frame] = []
            while True:
                with span("track.decode_wait"):
                    frames = carry + list(itertools.islice(it, block + 1 - len(carry)))
                if len(frames) < 2:
                    break
                if progress:
                    print(f"processing frames {frames[0].index}..{frames[-1].index - 1}",
                          flush=True)
                with span("track.stack"):
                    stack_np = stack_pad_host([f.gray for f in frames], block + 1, height,
                                              width, Hp, Wp, out=next(bufs))
                with span("track.upload"):
                    stack = torch.from_numpy(stack_np).to(dev, non_blocking=True)
                yield stack, [f.index for f in frames[:-1]], [f.timestamp for f in frames]
                if len(frames) < block + 1:  # the feed ended inside this block
                    break
                carry = frames[-1:]

    _track_blocks(problem, lens, pts, (height, width), uploads(), dev)
