"""Batched PreSync / Sync over a leading window axis, stacked tables for
multi-clip batches, and the window axis sharded over devices."""
