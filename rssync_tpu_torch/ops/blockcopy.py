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
"""

from __future__ import annotations

import torch

#: kernel launches, counted where the wrapper launches its kernel
LAUNCHES = {"copy_block": 0}
#: the (T, Hp, Wp, n, dtype) shapes the kernel was launched at
LAUNCH_SHAPES = {"copy_block": set()}


def reset_launch_counters() -> None:
    """Zero LAUNCHES and empty LAUNCH_SHAPES."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        LAUNCH_SHAPES[name].clear()


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
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.copy_block_launch(frames.data_ptr(), start.data_ptr(), out.data_ptr(), T, n,
                                   frame_bytes, sms, stream)
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
