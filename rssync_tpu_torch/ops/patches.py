"""Square float32 patches of an image at per-patch integer origins
(kernel E1/E3/E4 of experiments/pallas_patch.py, mb_extract.py and
mb_extract2.py), and the origin clamps their callers apply.

- `extract_patches(img, origins, size)` returns (N, size, size) float32
  patches with top-left corners at `origins` (N, 2) int32 xy, which the
  caller has clamped so every patch lies inside the image. On CPU
  tensors it computes the plain version `extract_patches_ref` and raises
  on an origin outside the image; on CUDA tensors it launches the kernel
  of csrc/extract_patches.cu or raises. The kernel reads the origins on
  the card, checks them itself and traps on one outside (a CUDA error at
  the next synchronization).
- `clamp_aligned` is the experiments' pre-clamp: the tile-aligned
  superset region a TPU DMA copies stays inside the image.
- `clamp_slice` is `jax.lax.dynamic_slice`'s treatment of a start: a
  negative one counts from the end, then it is clamped into bounds.
"""

from __future__ import annotations

import torch

LANE = 128
DTYPES = (torch.uint8, torch.bfloat16, torch.float32)
#: most patches one block of the kernel walks (8 bytes of shared memory each)
MAX_PER_BLOCK = 1024

#: kernel launches, counted where the wrapper launches its kernel
LAUNCHES = {"extract_patches": 0}
#: the (H, W, N, size, dtype, patches_per_block) shapes it was launched at
LAUNCH_SHAPES = {"extract_patches": set()}


def reset_launch_counters() -> None:
    """Zero LAUNCHES and empty LAUNCH_SHAPES."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        LAUNCH_SHAPES[name].clear()


def row_align(dtype: torch.dtype) -> int:
    """The TPU's sublane tile of a dtype: rows a DMA start aligns to
    (float32 8, bfloat16 16, uint8 32)."""
    return {4: 8, 2: 16, 1: 32}[dtype.itemsize]


def clamp_aligned(origins: torch.Tensor, H: int, W: int, rows: int, cols: int,
                  sub: int, lane: int = LANE) -> torch.Tensor:
    """Clamp (N, 2) xy origins so the aligned region (rows x cols from
    (floor(y / sub) * sub, floor(x / lane) * lane)) stays in an H x W
    image: x <= (W - cols) // lane * lane + lane - 1, likewise y."""
    x_max = (W - cols) // lane * lane + lane - 1
    y_max = (H - rows) // sub * sub + sub - 1
    return torch.stack([origins[:, 0].clamp(0, x_max), origins[:, 1].clamp(0, y_max)], dim=1)


def slice_start(start: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """jax.lax.dynamic_slice's start along one axis: a negative start
    counts from the end (start + dim), then it is clamped into
    [0, dim - size]."""
    return torch.where(start < 0, start + dim, start).clamp(0, dim - size)


def clamp_slice(origins: torch.Tensor, H: int, W: int, size: int) -> torch.Tensor:
    """Clamp (N, 2) xy origins as dynamic_slice treats a start (see
    `slice_start`): into [0, W - size] x [0, H - size]."""
    return torch.stack([slice_start(origins[:, 0], W, size),
                        slice_start(origins[:, 1], H, size)], dim=1)


def extract_patches_ref(img: torch.Tensor, origins: torch.Tensor, size: int) -> torch.Tensor:
    """Plain version of `extract_patches`: one advanced-index gather of
    the windows, rows and columns clamped to the image (edge replication,
    which leaves in-bounds windows as they are), then float32."""
    H, W = img.shape
    ar = torch.arange(size, device=img.device)
    rows = torch.clamp(origins[:, 1].long()[:, None] + ar, 0, H - 1)
    cols = torch.clamp(origins[:, 0].long()[:, None] + ar, 0, W - 1)
    return img[rows[:, :, None], cols[:, None, :]].float()


def _check(img, origins, size, patches_per_block) -> None:
    if img.dim() != 2:
        raise ValueError(f"extract_patches: img must be (H, W), got {tuple(img.shape)}")
    if img.dtype not in DTYPES:
        raise TypeError(f"extract_patches: img must be uint8, bfloat16 or float32, got {img.dtype}")
    if origins.dim() != 2 or origins.shape[1] != 2:
        raise ValueError(f"extract_patches: origins must be (N, 2), got {tuple(origins.shape)}")
    if origins.dtype != torch.int32:
        raise TypeError(f"extract_patches: origins must be int32, got {origins.dtype}")
    if not (img.is_contiguous() and origins.is_contiguous()):
        raise ValueError("extract_patches: inputs must be contiguous")
    if origins.device != img.device:
        raise ValueError(f"extract_patches: origins on {origins.device}, img on {img.device}")
    H, W = img.shape
    if not 1 <= size <= min(H, W):
        raise ValueError(f"extract_patches: size {size} for an image of {H}x{W}")
    if not 1 <= patches_per_block <= MAX_PER_BLOCK:
        raise ValueError(
            f"extract_patches: patches_per_block {patches_per_block} outside [1, {MAX_PER_BLOCK}]")


def _launch(img, origins, size, patches_per_block) -> torch.Tensor:
    from rssync_tpu_torch.ops import _kernels

    dev = img.device
    if dev.type != "cuda":
        raise ValueError(f"extract_patches: unsupported device {dev}")
    H, W = img.shape
    N = origins.shape[0]
    if patches_per_block * size * size >= 2**31:
        raise ValueError(f"extract_patches: {patches_per_block} patches of {size}^2 per block")
    out = torch.empty((N, size, size), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    lib = _kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.extract_patches_launch(
            img.data_ptr(), origins.data_ptr(), out.data_ptr(), N, H, W, img.stride(0), size,
            img.element_size(), patches_per_block, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"extract_patches launch failed: {lib.extract_patches_error_string(rc).decode()}")
    LAUNCHES["extract_patches"] += 1
    LAUNCH_SHAPES["extract_patches"].add((H, W, N, size, str(img.dtype), patches_per_block))
    return out


def extract_patches(img: torch.Tensor, origins: torch.Tensor, size: int,
                    patches_per_block: int = 1) -> torch.Tensor:
    """(N, size, size) float32 patches: out[n, r, c] = img[y_n + r, x_n + c].
    img: (H, W) uint8, bfloat16 or float32; origins: (N, 2) int32 xy on
    the image's device, clamped by the caller into [0, W - size] x
    [0, H - size]. patches_per_block: patches one block of the kernel
    walks (the counterpart of E4's DMA ring depth). Replaces
    experiments/pallas_patch.py _extract_pallas and the make_pallas
    kernels of experiments/mb_extract.py and mb_extract2.py."""
    _check(img, origins, size, patches_per_block)
    if img.device.type == "cpu":
        H, W = img.shape
        x, y = origins[:, 0], origins[:, 1]
        bad = (x < 0) | (x > W - size) | (y < 0) | (y > H - size)
        if bool(bad.any()):
            n = int(bad.nonzero()[0, 0])
            raise ValueError(f"extract_patches: origin {origins[n].tolist()} of a {size}-patch "
                             f"outside a {H}x{W} image")
        return extract_patches_ref(img, origins, size)
    return _launch(img, origins, size, patches_per_block)
