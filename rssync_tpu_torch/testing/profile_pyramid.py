"""The tracker's sparse pyramid on a CUDA card: float64 GEMMs (the port's)
against float32 ones, at the tracker's operating point.

    python -m rssync_tpu_torch.testing.profile_pyramid

241 noise frames of 2704x2028 (stored 2816x2056, made on the card), the
levels {2, 5, 7} the schedule reads, built as `build_pyramid_sparse`
builds them with its two GEMMs a level summed in float64 and, beside
it, in float32. For each dtype it prints, per level, how many pixels of
the whole-clip build (the hybrid structure's batch of 241 frames)
differ from a build of one 17-frame block (the block structure's
batch), for the first and the last block, and the time of one
17-frame block (CUDA events, median of 5 after a warm-up). Float64
sums u8 pixels times the bf16-rounded weights exactly, so its levels
cannot depend on the batch; float32's are exact for no level past 2.

The last line is all of it as one JSON object.
"""

from __future__ import annotations

import json
import statistics
import sys

import torch

from rssync_tpu_torch.frontend import tracking as TR

H, W = 2028, 2704
CHUNK = 16
N_FRAMES = 15 * CHUNK + 1


def _pyramid(img: torch.Tensor, dtype: torch.dtype) -> dict:
    """build_pyramid_sparse's small levels with its GEMMs in `dtype`."""
    levels = TR.auto_levels(H, W)
    need, plan, _ = TR._level_plan(levels, TR.LK_ITERS, TR.LK_RADIUS)
    pyr, prev_lvl, prev, (h, w) = {}, 0, img, (H, W)
    for lvl in need[1:]:
        hd, wd = TR._lvl_size(h, prev_lvl, lvl), TR._lvl_size(w, prev_lvl, lvl)
        hs, ws = TR._stored_dims(hd, wd, plan.get(lvl))
        R = TR._down_weights(h, prev_lvl, lvl, prev.shape[-2], hs, img.device).to(dtype)
        C = TR._down_weights(w, prev_lvl, lvl, prev.shape[-1], ws, img.device).to(dtype)
        x = prev.to(torch.bfloat16).to(dtype)
        pyr[lvl] = TR._cast_like(torch.matmul(torch.matmul(R, x), C.T), img.dtype)
        prev_lvl, prev, (h, w) = lvl, pyr[lvl], (hd, wd)
    return pyr


def _block_ms(img: torch.Tensor, dtype: torch.dtype, reps: int = 5) -> float:
    _pyramid(img, dtype)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _pyramid(img, dtype)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_pyramid: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    Hp, Wp = TR._stored_dims(H, W, "fine")
    gen = torch.Generator(device=dev).manual_seed(0)
    clip = torch.randint(0, 256, (N_FRAMES, Hp, Wp), dtype=torch.uint8, device=dev,
                         generator=gen)
    out = {"device": torch.cuda.get_device_name(0), "frames": N_FRAMES}
    levels = TR.auto_levels(H, W)
    need, plan, _ = TR._level_plan(levels, TR.LK_ITERS, TR.LK_RADIUS)
    port = TR.build_pyramid_sparse(clip[:CHUNK + 1], levels, need[1:], (H, W), plan)
    mine = _pyramid(clip[:CHUNK + 1], torch.float64)
    out["float64_is_the_port"] = all(torch.equal(port[lvl], mine[lvl]) for lvl in mine)
    print(f"# float64 levels equal build_pyramid_sparse's: {out['float64_is_the_port']}",
          flush=True)
    for name, dtype in (("float64", torch.float64), ("float32", torch.float32)):
        whole = _pyramid(clip, dtype)
        diff = {}
        for s in (0, N_FRAMES - 1 - CHUNK):
            block = _pyramid(clip[s:s + CHUNK + 1], dtype)
            diff[s] = {lvl: int((whole[lvl][s:s + CHUNK + 1] != block[lvl]).sum())
                       for lvl in block}
        ms = _block_ms(clip[:CHUNK + 1], dtype)
        out[name] = {"block_ms": ms, "differing_px": diff}
        print(f"# {name}: {ms:.3f} ms a {CHUNK + 1}-frame block; pixels of the "
              f"{N_FRAMES}-frame build differing from a block's, by block start and "
              f"level: {diff}", flush=True)
        del whole
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
