"""The u8 -> bf16 frame conversion pass (kernels E5 and E6 of
experiments/r4_u8pass.py and experiments/r4_u8pass2.py).

`u8_to_bf16` converts a uint8 tensor of any shape to bfloat16. On CPU
tensors it computes the plain version `u8_to_bf16_ref`; on CUDA tensors
it launches the kernel of csrc/convert_u8.cu or raises. Every u8 value
is exact in bf16, so the two are bit-equal. Unlike the TPU kernels,
whose grid of Hp // 256 row blocks leaves the last Hp % 256 rows of
each frame unwritten, every element is converted.
"""

from __future__ import annotations

import torch

#: kernel launches, counted where the wrapper launches its kernel
LAUNCHES = {"u8_to_bf16": 0}
#: the shapes the kernel was launched at
LAUNCH_SHAPES = {"u8_to_bf16": set()}


def reset_launch_counters() -> None:
    """Zero LAUNCHES and empty LAUNCH_SHAPES."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        LAUNCH_SHAPES[name].clear()


def u8_to_bf16_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `u8_to_bf16`."""
    return x.to(torch.bfloat16)


def _launch(x: torch.Tensor) -> torch.Tensor:
    from rssync_tpu_torch.ops import _kernels

    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"u8_to_bf16: unsupported device {dev}")
    if not x.is_contiguous():
        raise ValueError("u8_to_bf16: input must be contiguous")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=dev)
    if x.numel() == 0:
        return out
    lib = _kernels.load()
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.convert_u8_bf16_launch(x.data_ptr(), out.data_ptr(), x.numel(), sms, stream)
    if rc != 0:
        raise RuntimeError(
            f"u8_to_bf16 launch failed: {lib.convert_u8_bf16_error_string(rc).decode()}")
    LAUNCHES["u8_to_bf16"] += 1
    LAUNCH_SHAPES["u8_to_bf16"].add(tuple(x.shape))
    return out


def u8_to_bf16(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 copy of a uint8 tensor of any shape. Replaces
    experiments/r4_u8pass.py and experiments/r4_u8pass2.py
    pallas_convert."""
    if x.dtype != torch.uint8:
        raise TypeError(f"u8_to_bf16: input must be uint8, got {x.dtype}")
    if x.device.type == "cpu":
        return u8_to_bf16_ref(x)
    return _launch(x)
