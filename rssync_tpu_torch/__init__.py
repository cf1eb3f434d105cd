"""rssync_tpu_torch — the PyTorch + CUDA port of the rssync_tpu sync engine.

Recovers the clock delay between a rolling-shutter camera video and its
gyroscope log, with the same ISyncProblem surface as `rssync_tpu`
(`create_sync_problem` -> `set_gyro_quaternions` / `set_track_result` /
`pre_sync` / `sync` / `debug_pre_sync`). Plain tensor math is PyTorch;
the RANSAC hypothesis scoring is a hand-written CUDA kernel for Hopper
(`csrc/score_quartile.cu`), built with nvcc at first use.

Layering (mirrors rssync_tpu):

  ops/       quaternions, splines, robust-loss helpers, the scoring kernel
  core/      epipolar problem, RANSAC, PreSync, Sync, the SyncProblem API
  parallel/  batched PreSync / Sync over a leading window axis
  pipeline/  the batched syncpoint run
  testing/   synthetic engine problems with known delay
  utils/     invariant guards

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
