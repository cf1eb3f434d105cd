"""rssync_tpu_torch — the PyTorch + CUDA port of rssync_tpu.

Recovers the clock delay between a rolling-shutter camera video and its
gyroscope log, with the same ISyncProblem surface as `rssync_tpu`
(`create_sync_problem` -> `set_gyro_quaternions` / `set_track_result` /
`pre_sync` / `sync` / `debug_pre_sync`) and its LK tracker. Plain
tensor math is PyTorch; the RANSAC hypothesis scoring
(`csrc/score_quartile.cu`) and the tracker's strip fetch
(`csrc/gather_strips.cu`) are hand-written CUDA kernels for Hopper,
built with nvcc at first use. Entry points run on the card unless the
caller asks for the CPU.

Layering (mirrors rssync_tpu):

  ops/       quaternions, splines, robust-loss helpers, the fisheye lens,
             the gyro DSP, the scoring and strip-fetch kernels
  frontend/  telemetry ingest (seven formats; the native parser of
             native/gpmf through ctypes when built), the telemetry probe,
             lens profiles, gyro integration, axis conventions, the LK
             tracker with rolling-shutter timestamps and ray lifting
  core/      epipolar problem, RANSAC, PreSync, Sync (IRLS or batched
             L-BFGS motion), the SyncProblem API
  parallel/  batched PreSync / Sync over a leading window axis
  pipeline/  gyro intake from a telemetry file or rates, and the batched
             syncpoint run
  analysis/  the sync-quality metric
  testing/   synthetic problems, rendered clips and scenes, the golden
             scenes, profilers
  utils/     invariant guards, stage timings, the track cache

float32 math is pinned to IEEE at import: TF32 would silently drop
mantissa bits from every float32 matmul and convolution on the card.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from rssync_tpu_torch.core.api import SyncProblem, create_sync_problem  # noqa: E402

__all__ = ["SyncProblem", "create_sync_problem"]
__version__ = "0.1.0"
