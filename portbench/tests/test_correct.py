"""What decides `correct`: the control, the plain reference in the
program's place computed in bfloat16, comes out not correct; so does a
run whose timed path is broken underneath, once for each fault a cell
can have."""

import numpy as np
import pytest

from portbench import control, harness
from rssync_tpu_torch.core.api import SyncProblem
from rssync_tpu_torch.frontend import tracking
from rssync_tpu_torch.pipeline import recipe

SEED = 2**31 + 11


@pytest.mark.parametrize("cell", ["tiny.clip", "tiny.point"])
def test_control_is_not_correct(tiny_root, cell):
    c = harness.find_cell(cell, tiny_root)
    clip = harness.make_clip(c.config, SEED, "cpu", render=False)
    ok, checks = harness.judge(harness.compare(c, clip, control.control_requests(c, clip)),
                               c.limits)
    assert not ok
    for name in ("track_err_px_p50", "track_err_px_p90", "sync_err_ms_max"):
        assert checks[name]["value"] > checks[name]["limit"], name


def _still_tracks(frames, pts=None, *args, grid_step=None, logical_hw=None, **kw):
    """The tracker returning its state unchanged: every point where it
    started."""
    H, W = logical_hw
    g = tracking.grid_points(W, H, grid_step)
    import torch

    return torch.as_tensor(g, dtype=torch.float32)[None].expand(frames.shape[0] - 1, -1, -1)


def _half_pairs(orig):
    def emit(problem, lens, pts, tracked, frame_idx, frame_ts, height):
        P = (len(frame_idx) + 1) // 2
        return orig(problem, lens, pts, tracked[:P], frame_idx[:P], frame_ts[:P + 1], height)
    return emit


def _half_windows_mean(orig):
    def stage(sp, wins, delays, init, radius, motion_opt="irls"):
        res = orig(sp, wins, delays, init, radius, motion_opt)
        d = res[-1].delay
        half = (len(d) + 1) // 2
        d[half:] = d[:half].mean()
        return res
    return stage


def _altered_batched(orig):
    def stage(*a, **k):
        res = orig(*a, **k)
        res[-1].delay[0] += 1e-3
        return res
    return stage


def _altered_sequential(orig):
    def sync(self, *a, **k):
        cost, delay = orig(self, *a, **k)
        return cost, delay + 1e-3
    return sync


FAULTS = {
    "state unchanged": ("tiny.clip", lambda mp: mp.setattr(tracking, "lk_track_video",
                                                           _still_tracks)),
    "half the pairs left out": ("tiny.point", lambda mp: mp.setattr(
        tracking, "emit_track_block", _half_pairs(tracking.emit_track_block))),
    "half the windows, the mean for the rest": ("tiny.clip", lambda mp: mp.setattr(
        recipe, "sync_stage", _half_windows_mean(recipe.sync_stage))),
    "an answer altered (batched)": ("tiny.clip", lambda mp: mp.setattr(
        recipe, "sync_stage", _altered_batched(recipe.sync_stage))),
    "an answer altered (sequential)": ("tiny.point", lambda mp: mp.setattr(
        SyncProblem, "sync", _altered_sequential(SyncProblem.sync))),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    cell, plant = FAULTS[fault]
    assert harness.run(cell, SEED, 0.5, False, "cpu", tiny_root)["correct"] is True
    plant(monkeypatch)
    out = harness.run(cell, SEED, 0.5, False, "cpu", tiny_root)
    assert out["correct"] is False, out["checks"]
    assert np.isfinite(out["checks"]["sync_err_ms_max"]["value"])
