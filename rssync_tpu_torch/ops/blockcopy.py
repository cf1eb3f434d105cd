"""Copy n frames of a clip from a start index held on the device (kernel
E7 of experiments/r4_slice2.py).

`copy_block(frames, start, n)` returns frames[start : start + n] as a
new tensor. `start` is a one-element int32 tensor on the frames' device,
so on the card no host synchronization is needed to read it. On CPU
tensors it computes the plain version `copy_block_ref`, an index gather
of start + arange(n); on CUDA tensors it launches the kernel of
csrc/copy_block.cu or raises. The kernel checks 0 <= start <= T - n
itself and traps on a start that does not satisfy it (a CUDA error at
the next synchronization).

The kernel moves the block with Hopper's bulk copies through a
shared-memory ring, in chunks of STAGE_BYTES dealt round-robin to its
CTAs; how many CTAs is decided here, by `copy_plan`, and `plan_chunks`
lists the chunks the kernel walks, so the CPU tests can hold the plan
to covering the block exactly once.
"""

from __future__ import annotations

import torch

#: bytes of one chunk, a stage of the kernel's ring (csrc/copy_block.cu's
#: kStageBytes; the last chunk of a block may be shorter)
STAGE_BYTES = 48 * 1024

#: kernel launches, counted where the wrapper launches its kernel
LAUNCHES = {"copy_block": 0}
#: the (T, Hp, Wp, n, dtype) shapes the kernel was launched at
LAUNCH_SHAPES = {"copy_block": set()}


def reset_launch_counters() -> None:
    """Zero LAUNCHES and empty LAUNCH_SHAPES."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        LAUNCH_SHAPES[name].clear()


def copy_plan(total_bytes: int, sm_count: int) -> int:
    """CTAs the kernel copies a block of total_bytes (a positive multiple
    of 16) with: one an SM, and no more than there are chunks of
    STAGE_BYTES. Chunk i goes to CTA i % ctas, so at any moment the
    grid's loads fall in one window of the block."""
    if total_bytes < 16 or total_bytes % 16:
        raise ValueError(f"copy_plan: a block of {total_bytes} bytes must be a positive "
                         "multiple of 16")
    return max(1, min(sm_count, -(-total_bytes // STAGE_BYTES)))


def plan_chunks(ctas: int, total_bytes: int) -> list[tuple[int, int, int]]:
    """(cta, offset, bytes) of every chunk the kernel copies on `ctas`
    CTAs, in the order each CTA issues them (csrc/copy_block.cu's walk:
    chunk c + k * ctas of CTA c)."""
    return [(c, o, min(STAGE_BYTES, total_bytes - o)) for c in range(ctas)
            for o in range(c * STAGE_BYTES, total_bytes, ctas * STAGE_BYTES)]


def copy_edges(sm_count: int) -> list[tuple[str, tuple, str, int, int]]:
    """(label, frames shape, dtype, start, n) of the kernel's edge cases
    on a card of sm_count SMs: n = 1, n = T, the last start, one 16-byte
    frame, a block under one stage, blocks one 16-byte vector past a
    stage (the block's; and every CTA's) and a float32 clip whose frames
    span the bytes of a u8 64x256 one."""
    st = STAGE_BYTES // 16
    return [
        ("n = 1", (33, 64, 256), "uint8", 7, 1),
        ("n = T", (33, 64, 256), "uint8", 0, 33),
        ("start = T - n", (33, 64, 256), "uint8", 28, 5),
        ("one 16-byte frame", (3, 16), "uint8", 2, 1),
        ("under one stage", (9, 16, 16), "uint8", 4, 3),
        ("a stage and a vector", (st + 4, 16), "uint8", 3, st + 1),
        ("a stage and a vector a CTA", (sm_count * st + 3, 16), "uint8", 2, sm_count * st + 1),
        ("float32", (33, 64, 64), "float32", 15, 17),
    ]


def edge_frames(shape: tuple, dtype: str, dev: torch.device, seed: int) -> torch.Tensor:
    """Seeded frames of one `copy_edges` case on `dev`."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if dtype == "uint8":
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
    return torch.rand(shape, dtype=getattr(torch, dtype), device=dev, generator=gen)


def copy_block_ref(frames: torch.Tensor, start: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of `copy_block`: gather of frames start + arange(n)."""
    idx = start.reshape(()).long() + torch.arange(n, device=frames.device)
    return frames[idx]


def _check(frames: torch.Tensor, start: torch.Tensor, n: int) -> None:
    if frames.dim() < 1:
        raise ValueError("copy_block: frames needs a leading frame axis")
    if start.numel() != 1 or start.dtype != torch.int32:
        raise TypeError(
            f"copy_block: start must be one int32 value, got {start.dtype} {tuple(start.shape)}")
    if start.device != frames.device:
        raise ValueError(f"copy_block: start on {start.device}, frames on {frames.device}")
    if not 0 <= n <= frames.shape[0]:
        raise ValueError(f"copy_block: n={n} frames of {frames.shape[0]}")


#: SM count by CUDA device index, read once
_SMS: dict[int, int] = {}


def sm_count(dev: torch.device) -> int:
    """The SM count of CUDA device `dev`, read once a device."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _launch(frames: torch.Tensor, start: torch.Tensor, n: int) -> torch.Tensor:
    from rssync_tpu_torch.ops import _kernels

    dev = frames.device
    if dev.type != "cuda":
        raise ValueError(f"copy_block: unsupported device {dev}")
    if not (frames.is_contiguous() and start.is_contiguous()):
        raise ValueError("copy_block: inputs must be contiguous")
    T = frames.shape[0]
    frame_bytes = frames[0].numel() * frames.element_size() if T else 0
    if frame_bytes % 16 or frames.data_ptr() % 16:
        raise ValueError(
            f"copy_block: frames of {frame_bytes} bytes must be 16-byte multiples, 16-byte aligned")
    out = torch.empty((n, *frames.shape[1:]), dtype=frames.dtype, device=dev)
    if n == 0 or frame_bytes == 0:
        return out
    lib = _kernels.load()
    with torch.cuda.device(dev):
        ctas = copy_plan(n * frame_bytes, sm_count(dev))
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.copy_block_launch(frames.data_ptr(), start.data_ptr(), out.data_ptr(), T, n,
                                   frame_bytes, ctas, stream)
    if rc != 0:
        raise RuntimeError(f"copy_block launch failed: {lib.copy_block_error_string(rc).decode()}")
    LAUNCHES["copy_block"] += 1
    LAUNCH_SHAPES["copy_block"].add((*frames.shape, n, str(frames.dtype)))
    return out


def copy_block(frames: torch.Tensor, start: torch.Tensor, n: int) -> torch.Tensor:
    """frames[start : start + n] as a new tensor. frames: (T, ...) of any
    dtype, whose frames span a multiple of 16 bytes on the card; start:
    one int32 value on the frames' device with 0 <= start <= T - n.
    Replaces experiments/r4_slice2.py dma_block."""
    _check(frames, start, n)
    if frames.device.type == "cpu":
        s = int(start.reshape(()))
        if not 0 <= s <= frames.shape[0] - n:
            raise ValueError(f"copy_block: start {s} outside [0, {frames.shape[0] - n}]")
        return copy_block_ref(frames, start, n)
    return _launch(frames, start, n)
