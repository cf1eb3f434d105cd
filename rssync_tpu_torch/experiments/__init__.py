"""Harnesses of the round-4 probe kernels (ports of experiments/r4_*.py).

Each module runs the variants of the experiment it is named after, at
the same operating point, with the port's kernels in place of the
Pallas ones:

    python -m rssync_tpu_torch.experiments.r4_u8pass [variants]   # E5
    python -m rssync_tpu_torch.experiments.r4_u8pass2 [variants]  # E6
    python -m rssync_tpu_torch.experiments.r4_slice2 [variants]   # E7
    python -m rssync_tpu_torch.experiments.r4_i16score            # E8

They run on a CUDA card and print ms and GB/s per variant, timed with
CUDA events; without a card they exit non-zero. `run(...,
device="cpu", small=True)` runs the same code at a small shape with the
plain versions, untimed. Nothing here is on the tracker's or the
engine's main path.
"""
