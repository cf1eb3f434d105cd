"""Batched PreSync / Sync over a leading window axis."""
