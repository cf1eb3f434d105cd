"""Sync-quality analysis (ref: python/plot_sync.py, plot_any.py)."""

from rssync_tpu_torch.analysis.metrics import (  # noqa: F401
    SyncQuality,
    sync_rmse,
    sync_rmse_from_csv,
    to_gyroflow_offset,
)
