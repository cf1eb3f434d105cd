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
- `kernel_launch`, `kernel_walk` and `kernel_loads` model the kernel's
  launch, which thread writes which output vector, and every pixel load
  it issues, so the CPU tests can hold its mapping and its wide loads.
"""

from __future__ import annotations

import numpy as np
import torch

LANE = 128
DTYPES = (torch.uint8, torch.bfloat16, torch.float32)
#: largest patches_per_block accepted (the kernel's depth stops at MAX_DEPTH)
MAX_PER_BLOCK = 1024
#: output vectors (four float32 each, 4 KB in all) one block writes
VECTORS_PER_BLOCK = 256
#: most vectors one thread loads before its first store
MAX_DEPTH = 8
#: the patch size with a row-vector instance; any other takes the generic one
ROW_SIZE = 40

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


def kernel_launch(N: int, size: int, patches_per_block: int) -> tuple[int, int, int]:
    """(blocks, threads a block, depth) of the kernel's launch: each
    block writes VECTORS_PER_BLOCK output vectors whatever
    patches_per_block is; patches_per_block, rounded down to 1, 2, 4 or
    8, is each thread's depth, the vectors it loads before its first
    store, and the block runs VECTORS_PER_BLOCK / depth threads."""
    depth = 1 << (min(patches_per_block, MAX_DEPTH).bit_length() - 1)
    blocks = -(-N * size * size // (4 * VECTORS_PER_BLOCK))
    return blocks, VECTORS_PER_BLOCK // depth, depth


def kernel_walk(N: int, size: int, patches_per_block: int) -> dict[str, np.ndarray]:
    """Every output vector a thread of the kernel writes, in the kernel's
    order: `block`, `thread`, `slot` (the j-th vector of its thread,
    vector = block * VECTORS_PER_BLOCK + slot * threads + thread), and
    `elems` (M, 4, 3), the (patch, row, column) of each of the vector's
    four floats, -1 past the end. At size ROW_SIZE a vector is four
    pixels of one patch row; at any other it is four consecutive output
    floats, which may cross rows and patches."""
    blocks, threads, depth = kernel_launch(N, size, patches_per_block)
    b, j, t = np.meshgrid(np.arange(blocks), np.arange(depth), np.arange(threads), indexing="ij")
    v = (b * VECTORS_PER_BLOCK + j * threads + t).ravel()
    keep = v < -(-N * size * size // 4)
    b, j, t, v = b.ravel()[keep], j.ravel()[keep], t.ravel()[keep], v[keep]
    e = 4 * v[:, None] + np.arange(4)
    n, k = np.divmod(e, size * size)
    r, c = np.divmod(k, size)
    elems = np.where((e < N * size * size)[..., None], np.stack([n, r, c], axis=-1), -1)
    return dict(block=b, thread=t, slot=j, vector=v, elems=elems)


def kernel_loads(walk: dict[str, np.ndarray], size: int, origins: np.ndarray, pitch: int,
                 itemsize: int, base: int) -> dict[str, np.ndarray]:
    """Every pixel load the kernel issues for the vectors of `walk`, with
    the image's first byte at address `base` (its alignment is what
    matters) and rows `pitch` elements apart: `vector` (index into the
    walk), `patch`, byte `address` and `width`. At size ROW_SIZE the four
    pixels at address a of a patch row load as: float32 one 16-byte load
    if a % 16 == 0; u8 one word if a % 4 == 0; bf16 two words if
    a % 4 == 0; a misaligned u8 or bf16 vector that is neither the first
    nor the last of its row loads the aligned words that cover it (two,
    or three for bf16); everything else one load a pixel. At any other
    size every pixel is one load."""
    elems = walk["elems"]
    valid = elems[..., 0] >= 0
    n = np.where(valid, elems[..., 0], 0)
    x, y = origins[n, 0], origins[n, 1]
    addr = base + ((y + elems[..., 1]) * pitch + x + elems[..., 2]) * itemsize
    idx = np.broadcast_to(np.arange(len(elems))[:, None], elems.shape[:2])
    if size != ROW_SIZE:
        return dict(vector=idx[valid], patch=n[valid], address=addr[valid],
                    width=np.full(int(valid.sum()), itemsize))
    a, vec, patch = addr[:, 0], idx[:, 0], n[:, 0]
    seg = elems[:, 0, 2] // 4
    edge = (seg == 0) | (seg == size // 4 - 1)
    m = a % (16 if itemsize == 4 else 4)
    loads = []  # (mask, address offsets from a, width)
    if itemsize == 4:
        loads.append((m == 0, [0], 16))
    elif itemsize == 2:
        loads.append((m == 0, [0, 4], 4))
        loads.append((~edge & (m != 0), [-2, 2, 6], 4))
    else:
        loads.append((m == 0, [0], 4))
        loads.append((~edge & (m != 0), [-m, 4 - m], 4))
    wide = np.any([mask for mask, _, _ in loads], axis=0)
    loads.append((~wide, [0, itemsize, 2 * itemsize, 3 * itemsize], itemsize))
    out = {k: [] for k in ("vector", "patch", "address", "width")}
    for mask, offsets, width in loads:
        for off in offsets:
            off = off[mask] if isinstance(off, np.ndarray) else off
            out["vector"].append(vec[mask])
            out["patch"].append(patch[mask])
            out["address"].append(a[mask] + off)
            out["width"].append(np.full(int(mask.sum()), width))
    return {k: np.concatenate(v) for k, v in out.items()}


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
    if N * size * size >= 2**31:
        raise ValueError(f"extract_patches: {N} patches of {size}^2 floats exceed 2^31 - 1")
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
    [0, H - size]. patches_per_block: E4's DMA ring depth, which on the
    card is each thread's depth, the output vectors it loads before its
    first store (1, 2, 4 or 8, rounded down; see `kernel_launch`); the
    grid does not shrink as it grows. Replaces
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
