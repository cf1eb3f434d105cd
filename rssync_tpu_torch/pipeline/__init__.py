"""JSON-recipe pipeline driver (ref: src/core_testcode.cpp:235-319)."""

from rssync_tpu_torch.pipeline.recipe import run_recipe

__all__ = ["run_recipe"]
