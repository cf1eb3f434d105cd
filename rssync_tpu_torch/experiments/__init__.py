"""Harnesses of the probe kernels (ports of experiments/*.py).

Each module runs the variants of the experiment it is named after, at
the same operating point, with the port's kernels in place of the
Pallas ones:

    python -m rssync_tpu_torch.experiments.r4_u8pass [variants]    # E5
    python -m rssync_tpu_torch.experiments.r4_u8pass2 [variants]   # E6
    python -m rssync_tpu_torch.experiments.r4_slice2 [variants]    # E7
    python -m rssync_tpu_torch.experiments.r4_i16score             # E8
    python -m rssync_tpu_torch.experiments.r3_dma [variants]       # E2
    python -m rssync_tpu_torch.experiments.mb_extract [variants]   # E3
    python -m rssync_tpu_torch.experiments.mb_extract2 [variants]  # E4

They run on a CUDA card and print ms and GB/s, or us per call and ns
per point, per variant, timed with CUDA events; without a card they
exit non-zero. `run(..., device="cpu", small=True)` runs the same code
at a small shape with the plain versions, untimed. `pallas_patch` holds
E1's function with its two routes (`extract_patches(..., force=)`) and
has no harness of its own. Nothing here is on the tracker's or the
engine's main path.
"""
