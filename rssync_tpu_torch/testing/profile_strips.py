"""K3, the tracker's search-strip fetch (`ops/strips.py::gather_strips`,
csrc/gather_strips.cu), on a CUDA card at every shape the port's paths
launch it at, beside `index_select`.

    python -m rssync_tpu_torch.testing.profile_strips
    python rssync_tpu_torch/testing/profile_strips.py --root DIR   # another checkout's K3

For each shape and each implementation: bit-equality with
`gather_strips_ref`; the kernel time (CUDA events, median of 20 calls,
each behind a 1 GiB overwrite: L2 cold); the profiler's kernel
duration (torch.profiler, the same 20 calls); 200 calls back to back in
one event pair (L2 warm, the host's enqueue cost included); the host
microseconds a call (perf_counter over those 200 calls, before the
synchronize), and the wrapper's parts alone (`host_parts`). The
implementations:
- `k3`: the wrapper `gather_strips` of the package imported (this
  checkout's, or with --root that of the checkout DIR, run as a file so
  its package and build are DIR's own: run an earlier checkout and this
  one in one session to compare them);
- `index_select`: one PyTorch call over the (T * Hp * Wp/128, 128) row
  view (the library yardstick; the port never calls it).
The last line is all of it as one JSON object; --out also writes it to
a file. `build_parent` / `parent_call` and `build_parent_copy` /
`parent_copy_call` let chip_smoke.py time the kernel of an earlier
gather_strips.cu and copy_block.cu alone (--parent-csrc).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: (label, (T, Hp, Wp, B, N, dtype), random fidx): every shape a path of
#: the port launches K3 at, then edge shapes
SHAPES = (
    ("tracker level 2 (phase 6)", (16, 536, 768, 16, 130, "torch.uint8"), False),
    ("tracker level 0 (phase 6)", (16, 2056, 2816, 16, 130, "torch.uint8"), False),
    ("hybrid level 0 (phase 21)", (241, 2056, 2816, 16, 130, "torch.uint8"), True),
    ("r3_dma (E2, phase 13)", (16, 2028, 2816, 16, 130, "torch.uint8"), False),
    ("1920x1080 level 2 (phase 17)", (16, 296, 512, 16, 91, "torch.uint8"), False),
    ("1920x1080 level 0 (phase 17)", (16, 1104, 1920, 16, 91, "torch.uint8"), False),
    ("float32, T != B", (9, 96, 384, 5, 17, "torch.float32"), True),
    ("float32 level 2", (16, 536, 768, 16, 130, "torch.float32"), False),
    ("1163 strips", (6, 120, 640, 1, 1163, "torch.uint8"), True),
    ("160 000 strips", (2, 48, 384, 160, 1000, "torch.uint8"), True),
)
REPS, BACK_TO_BACK = 20, 200
#: H100 SXM HBM3 bytes/s (NVIDIA's data sheet)
HBM_BYTES_S = 3.35e12


def strip_inputs(torch, ST, shape, dev, seed, random_fidx, edge=False):
    """Seeded image and indices at one launch shape: a random image,
    indices drawn over the whole valid range (with `edge`, every strip
    at the last valid row and block)."""
    import numpy as np

    T, Hp, Wp, B, N, dtype = shape
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if dtype == "torch.uint8":
        img = torch.randint(0, 256, (T, Hp, Wp), dtype=torch.uint8, device=dev, generator=gen)
    else:
        img = torch.rand((T, Hp, Wp), dtype=torch.float32, device=dev, generator=gen)
    max_oyq, max_obx = (Hp - ST.STRIP_ROWS) // 8, Wp // ST.LANE - 2
    if edge:
        oyq, obx = np.full((B, N), max_oyq), np.full((B, N), max_obx)
    else:
        oyq = rng.integers(0, max_oyq + 1, (B, N))
        obx = rng.integers(0, max_obx + 1, (B, N))
    fidx = rng.integers(0, T, B) if random_fidx else np.arange(B)
    i32 = dict(dtype=torch.int32, device=dev)
    return img, torch.tensor(oyq, **i32), torch.tensor(obx, **i32), torch.tensor(fidx, **i32)


def index_select_call(torch, ST, img, oyq, obx, fidx):
    """(fn, index) of one `index_select` fetching the same strips from the
    (T * Hp * Wp/128, 128) row view; fn returns them as (B, N, 40, 256)."""
    T, Hp, Wp = img.shape
    B, N = oyq.shape
    NB = Wp // ST.LANE
    rows = (fidx.long()[:, None, None] * Hp + 8 * oyq.long()[..., None]
            + torch.arange(ST.STRIP_ROWS, device=img.device))
    idx = (rows[..., None] * NB + obx.long()[..., None, None]
           + torch.arange(2, device=img.device)).reshape(-1)
    src = img.view(T * Hp * NB, ST.LANE)

    def fn():
        return torch.index_select(src, 0, idx).view(B, N, ST.STRIP_ROWS, 2 * ST.LANE)

    return fn, idx


def build_parent(src: Path):
    """An earlier K3 source with the first kernel's C interface
    (`gather_strips_launch(img, oyq, obx, fidx, out, B, N, T, Hp, Wp,
    itemsize, stream)`), built alone with the port's nvcc flags
    (`_kernels.build_single`) and bound with ctypes."""
    from rssync_tpu_torch.ops import _kernels

    lib = _kernels.build_single(src)
    lib.gather_strips_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.gather_strips_launch.restype = ctypes.c_int
    lib.gather_strips_error_string.argtypes = [ctypes.c_int]
    lib.gather_strips_error_string.restype = ctypes.c_char_p
    return lib


def parent_call(torch, lib, img, oyq, obx, fidx):
    """A call of a build_parent library on these inputs: allocate, launch
    on the current stream, raise on a failed launch."""
    T, Hp, Wp = img.shape
    B, N = oyq.shape
    args = (img.data_ptr(), oyq.data_ptr(), obx.data_ptr(), fidx.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream

    def fn():
        out = torch.empty((B, N, 40, 256), dtype=img.dtype, device=img.device)
        rc = lib.gather_strips_launch(*args, out.data_ptr(), B, N, T, Hp, Wp,
                                      img.element_size(), stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: {lib.gather_strips_error_string(rc).decode()}")
        return out

    return fn


def build_parent_copy(src: Path):
    """An earlier E7 source with the first kernel's C interface
    (`copy_block_launch(frames, start, out, T, n, frame_bytes, sm_count,
    stream)`), built alone with the port's nvcc flags
    (`_kernels.build_single`) and bound with ctypes."""
    from rssync_tpu_torch.ops import _kernels

    lib = _kernels.build_single(src)
    lib.copy_block_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.copy_block_launch.restype = ctypes.c_int
    lib.copy_block_error_string.argtypes = [ctypes.c_int]
    lib.copy_block_error_string.restype = ctypes.c_char_p
    return lib


def parent_copy_call(torch, lib, frames, start, n):
    """A call of a build_parent_copy library copying frames[start :
    start + n]: allocate, launch on the current stream, raise on a failed
    launch."""
    T = frames.shape[0]
    frame_bytes = frames[0].numel() * frames.element_size()
    sms = torch.cuda.get_device_properties(frames.device).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def fn():
        out = torch.empty((n, *frames.shape[1:]), dtype=frames.dtype, device=frames.device)
        rc = lib.copy_block_launch(frames.data_ptr(), start.data_ptr(), out.data_ptr(), T, n,
                                   frame_bytes, sms, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: {lib.copy_block_error_string(rc).decode()}")
        return out

    return fn


def event_ms(torch, fn, flush, reps: int = REPS, read_only: bool = False) -> float:
    """Median of `reps` CUDA-event-timed calls after one warm-up, each
    behind an overwrite of `flush` (L2 cold; the host enqueues while the
    device is busy with the flush, so the events time device work). With
    `read_only` the flush is an int32 sum over `flush` instead: it leaves
    the L2 cold too, but holding clean lines, none of which is written
    back inside the timed call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if read_only:
            flush.view(torch.int32).sum()
        else:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiler_ms(torch, fn, flush, reps: int = REPS, tries: int = 3) -> float | None:
    """Mean device duration (ms) of `fn`'s kernels (summed, if it launches
    several) over `reps` calls, each behind an overwrite of `flush`, from
    torch.profiler's CUDA activity: a first session of `fn` alone names
    its kernels. A session that recorded none of them is run again, up
    to `tries` times; None where none did."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(n, before=None):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            us = us if us is not None else e.self_cuda_time_total
            if us > 0:
                out[e.key] = us
        return out

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        names = set(kernels(3))
        timed = kernels(reps, flush.zero_)
        if names and names <= set(timed):
            return sum(timed[k] for k in names) / reps / 1e3
    return None


def back_to_back(torch, fn, reps: int = BACK_TO_BACK) -> tuple[float, float]:
    """(ms a call, host us a call) of `reps` calls in one event pair: the
    event time includes the host's enqueue cost where it exceeds the
    device's; the host time is perf_counter's before the synchronize."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, 1e6 * host / reps


def _us(fn, reps: int = 1000) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e6 * (time.perf_counter() - t0) / reps


def _enter_exit(ctx) -> None:
    with ctx:
        pass


def host_parts(torch, ST, img, oyq, obx, fidx) -> dict:
    """Host microseconds a call of the wrapper's parts: its checks, the
    output's allocation, the current stream's lookup (as a torch Stream,
    as a raw handle), a device context and, where the C launch takes a
    device (this kernel's interface), the C launch alone (tensor-map
    lookup or encoding, the grid and the kernel launch); enqueue only."""
    from rssync_tpu_torch.ops import _kernels

    B, N = oyq.shape
    T, Hp, Wp = img.shape
    shape = (B, N, ST.STRIP_ROWS, 2 * ST.LANE)
    parts = dict(
        checks=_us(lambda: ST._check(img, oyq, obx, fidx)),
        empty=_us(lambda: torch.empty(shape, dtype=img.dtype, device=img.device)),
        stream=_us(lambda: torch.cuda.current_stream(img.device).cuda_stream),
        device_context=_us(lambda: _enter_exit(torch.cuda.device(img.device))),
    )
    if hasattr(torch._C, "_cuda_getCurrentRawStream"):
        index = img.device.index or 0
        parts["raw_stream"] = _us(lambda: torch._C._cuda_getCurrentRawStream(index))
    lib = _kernels.load()
    if len(lib.gather_strips_launch.argtypes) == 13:
        out = torch.empty(shape, dtype=img.dtype, device=img.device)
        args = (img.data_ptr(), oyq.data_ptr(), obx.data_ptr(), fidx.data_ptr(),
                out.data_ptr(), B, N, T, Hp, Wp, img.element_size(), img.device.index,
                torch.cuda.current_stream(img.device).cuda_stream)
        parts["c_launch"] = _us(lambda: lib.gather_strips_launch(*args), 200)
        torch.cuda.synchronize()
    return parts


def strips_bytes(torch, ST, img, idx, B, N) -> int:
    """Bytes K3 must move: each image byte the strips cover read once,
    the strips written once, the indices read."""
    covered = int(torch.unique(idx).numel()) * ST.LANE * img.element_size()
    return covered + B * N * ST.STRIP_ROWS * 2 * ST.LANE * img.element_size() \
        + 4 * (2 * B * N + B)


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, help="import rssync_tpu_torch from this checkout")
    ap.add_argument("--out", type=Path, help="also write the JSON result here")
    args = ap.parse_args()
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("profile_strips: needs a CUDA device", file=sys.stderr)
        return 1
    from rssync_tpu_torch.ops import _kernels
    from rssync_tpu_torch.ops import strips as ST

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _kernels.load()
    result = {"card": card, "package": str(Path(ST.__file__).resolve().parents[1]),
              "build_s": time.perf_counter() - t0, "shapes": []}
    print(f"{card}\n# K3 of {result['package']}; build {result['build_s']:.2f} s", flush=True)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)

    def cases():
        """(label, inputs, want, index, {name: call}) a shape."""
        for seed, (label, shape, random_fidx) in enumerate(SHAPES):
            img, oyq, obx, fidx = strip_inputs(torch, ST, shape, dev, seed, random_fidx)
            lib_fn, idx = index_select_call(torch, ST, img, oyq, obx, fidx)
            impls = {"k3": lambda: ST.gather_strips(img, oyq, obx, fidx),
                     "index_select": lib_fn}
            yield label, (img, oyq, obx, fidx), ST.gather_strips_ref(img, oyq, obx, fidx), \
                idx, impls

    # first every host-side and event time, then the profiler's (a
    # profiler session may leave tracing hooks that slow later launches)
    for (label, shape, random_fidx), (_, inputs, want, idx, impls) in zip(SHAPES, cases()):
        n_bytes = strips_bytes(torch, ST, inputs[0], idx, *inputs[1].shape)
        row = dict(label=label, shape=list(shape), random_fidx=random_fidx,
                   bound_ms=n_bytes / HBM_BYTES_S * 1e3)
        for name, fn in impls.items():
            equal = bool(torch.equal(fn(), want))
            b2b, host = back_to_back(torch, fn)
            row[name] = dict(bit_equal=equal, ms=event_ms(torch, fn, flush),
                             back_to_back_ms=b2b, host_us=host)
        row["host_parts_us"] = host_parts(torch, ST, *inputs)
        result["shapes"].append(row)
        print(f"# {label} {shape} bound {row['bound_ms']:.4f} ms, wrapper host parts "
              f"{ {k: round(v, 2) for k, v in row['host_parts_us'].items()} } us: " + "; ".join(
                  f"{name} equal {r['bit_equal']} event {r['ms']:.4f} back-to-back "
                  f"{r['back_to_back_ms']:.4f} ms host {r['host_us']:.2f} us"
                  for name, r in row.items() if isinstance(r, dict) and "ms" in r), flush=True)
    for row, (label, inputs, want, _, impls) in zip(result["shapes"], cases()):
        for name, fn in impls.items():
            row[name]["profiler_ms"] = profiler_ms(torch, fn, flush)
        print(f"# {label}: profiler " + ", ".join(
            f"{name} {fmt_ms(row[name]['profiler_ms'])} ms" for name in impls), flush=True)
    text = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
