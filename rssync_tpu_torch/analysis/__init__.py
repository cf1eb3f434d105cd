"""Sync-quality analysis (ref: python/plot_sync.py)."""
