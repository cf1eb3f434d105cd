"""The port's span and counter recorder (rssync_tpu_torch/utils/timing.py)
and the spans the tracker and the Sync loop open, on the CPU: off by
default and then free of records; nesting, parents, context, self time
and counts from two threads; the clock shared with torch.profiler; and
tracks, PreSync and Sync delays bit-equal with recording on and off."""

import threading
import time

import numpy as np
import pytest
import torch

from rssync_tpu_torch.core.problem import build_track_window, make_spline_table
from rssync_tpu_torch.frontend import decode_pool as tdp
from rssync_tpu_torch.frontend import tracking as T
from rssync_tpu_torch.ops import lens as tlens
from rssync_tpu_torch.parallel import batch as B
from rssync_tpu_torch.testing.synthvideo import make_clip, write_clip_files
from rssync_tpu_torch.utils import timing
from rssync_tpu_torch.utils.timing import Timings, count, recording, span

torch.set_num_threads(2)

#: pair ranges that track_clip runs in blocks of 4 as blocks of 3, 4 and
#: 1 pairs (a range shorter than a block, then a tail of one pair)
RANGES, BLOCK = [(0, 3), (4, 9)], 4
#: children of a track_clip block's pull and enqueue, in the order they
#: open; the block it drains adds `track.emit`
BLOCK_CHILDREN = ["track.slice", "track.pyramid", "track.coarse", "track.lk"]
#: a drained block's: the tracked points' lift and reads, then the
#: host intake (the grid's rays were lifted and read once, in `track.grid`)
EMIT_CHILDREN = ["emit.lift", "emit.read", "emit.set"]


class _Problem:
    """Stands in for a SyncProblem: keeps what set_track_result gets."""

    def __init__(self):
        self.calls = {}

    def set_track_result(self, frame, *data):
        assert frame not in self.calls
        self.calls[frame] = data


def _children(rec, parent_id):
    return sorted((r for r in rec.records if r.parent == parent_id), key=lambda r: r.start_ns)


def _assert_calls_equal(a: _Problem, b: _Problem):
    assert sorted(a.calls) == sorted(b.calls)
    for f, data in a.calls.items():
        for x, y in zip(data, b.calls[f]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def clip():
    return make_clip(seed=3, n_frames=10, width=320, height=240, fps=30.0, device="cpu")


# ---------------------------------------------------------------------------
# the recorder


def test_recording_off_records_nothing():
    assert timing._active is None
    assert span("track.block") is span("sync.loop") is timing.NO_SPAN
    with span("track.block"):
        count("pairs", 3)
    with recording() as rec:
        assert span("a") is not timing.NO_SPAN
    with span("b"):
        count("host_reads")
    assert rec.records == [] and rec.counts == {}
    assert timing._active is None


def test_recordings_nest_and_restore():
    with recording() as outer:
        with recording() as inner, span("a"):
            pass
        with span("b"):
            pass
    assert [r.name for r in inner.records] == ["a"]
    assert [r.name for r in outer.records] == ["b"]
    assert timing._active is None


def test_spans_nest_with_parents_context_self_time_and_counts_in_two_threads():
    """Each thread keeps its own stack: a span's parent is the span open
    around it in its thread, counts land on the innermost open span, and
    self time is a span's time less its children's."""
    barrier = threading.Barrier(2, timeout=30)

    def work(tag):
        with span("outer"):
            count("n", 1)
            barrier.wait()
            with span("inner"):
                count("n", 10)
                count(tag)
                time.sleep(0.002)
            with span("inner"):
                count("n", 100)
            barrier.wait()

    with recording(context=5) as rec:
        threads = [threading.Thread(target=work, args=(t,)) for t in ("x", "y")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        rec.context = 6
        count("loose", 2)
        with span("late"):
            pass

    outers = [r for r in rec.records if r.name == "outer"]
    inners = [r for r in rec.records if r.name == "inner"]
    assert len(outers) == 2 and len(inners) == 4
    assert len({r.id for r in rec.records}) == len(rec.records)
    for o in outers:
        assert o.parent is None and o.context == 5 and o.counts == {"n": 1}
        mine = [r for r in inners if r.parent == o.id]
        assert len(mine) == 2
        assert all(o.start_ns <= r.start_ns <= r.end_ns <= o.end_ns for r in mine)
        assert sorted(r.counts["n"] for r in mine) == [10, 100]
    assert sorted(k for r in inners for k in r.counts if k != "n") == ["x", "y"]
    late = [r for r in rec.records if r.name == "late"]
    assert late[0].context == 6 and rec.counts == {"loose": 2}
    assert rec.counted("n") == 222 and rec.counted("loose") == 2

    s = rec.summary()
    assert s["outer"]["calls"] == 2 and s["inner"]["calls"] == 4
    assert s["outer"]["counts"] == {"n": 2} and s["inner"]["counts"]["n"] == 220
    total = sum(o.end_ns - o.start_ns for o in outers) * 1e-9
    inner_s = sum(r.end_ns - r.start_ns for r in inners) * 1e-9
    assert s["outer"]["total_s"] == pytest.approx(total, abs=1e-12)
    assert s["outer"]["self_s"] == pytest.approx(total - inner_s, abs=1e-12)
    assert s["inner"]["self_s"] == pytest.approx(s["inner"]["total_s"], abs=1e-12)
    assert s["inner"]["total_s"] >= 2 * 0.002


def test_timings_stages_are_spans():
    t = Timings()
    with recording() as rec:
        with t.stage("tracking"), span("track.block"):
            pass
    block, stage = rec.records
    assert (stage.name, stage.parent) == ("tracking", None)
    assert (block.name, block.parent) == ("track.block", stage.id)
    assert t.stages["tracking"].calls == 1


def test_span_clock_holds_the_profilers_events():
    """A span around `a @ a` contains the profiler's aten::mm event,
    both on time.time_ns()'s base."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof, recording() as rec:
        with span("mm"):
            a @ a
    (sp,) = rec.records
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert sp.start_ns <= e.start_ns() <= e.end_ns() <= sp.end_ns


# ---------------------------------------------------------------------------
# the tracker's spans


def test_track_clip_spans_and_tracks_bit_equal(clip):
    """Three blocks through the block runner: each pulled and enqueued in
    a `track.block` of its own, the first drained in the third's and the
    other two in one `track.block` each once the ranges are spent, their
    `track.emit` and counts under the `track.block` that drains them.
    Before them, one `track.grid` lifts and reads the grid's rays."""
    off, on = _Problem(), _Problem()
    T.track_clip(off, clip.lens, clip.frames, clip.frame_ts, RANGES, block=BLOCK)
    with recording(context=3) as rec:
        T.track_clip(on, clip.lens, clip.frames, clip.frame_ts, RANGES, block=BLOCK)
    _assert_calls_equal(on, off)

    blocks = sorted((r for r in rec.records if r.name == "track.block"),
                    key=lambda r: r.start_ns)
    # the clip's small motion leaves no point at its LK margin
    drained = [{"pairs": n, "lk_edge_points": 0} for n in (3, 4, 1)]
    assert [b.counts for b in blocks] == [{}, {}] + drained
    assert all(r.context == 3 for r in rec.records)
    kids = [_children(rec, b.id) for b in blocks]
    assert [[k.name for k in ks] for ks in kids] == (
        [BLOCK_CHILDREN] * 2 + [BLOCK_CHILDREN + ["track.emit"]] + [["track.emit"]] * 2)
    for b, ks in zip(blocks, kids):
        assert b.parent is None
        for e in (k for k in ks if k.name == "track.emit"):
            emit = _children(rec, e.id)
            assert [k.name for k in emit] == EMIT_CHILDREN
            assert sum(k.counts.get("host_reads", 0) for k in emit) == 2
            assert all(not _children(rec, k.id) for k in emit)
    (grid,) = [r for r in rec.records if r.name == "track.grid"]
    assert grid.parent is None and grid.end_ns <= blocks[0].start_ns
    assert [(k.name, k.counts) for k in _children(rec, grid.id)] == [
        ("emit.lift", {}), ("emit.read", {"host_reads": 1})]
    assert rec.counted("pairs") == len(on.calls) == 8
    assert rec.counted("lk_edge_points") == 0


def test_track_frames_spans(clip, tmp_path, monkeypatch):
    """track_frames (the FrameFeed thread) records a block's decode wait,
    host pad and upload, and its pairs, which equal track_clip's."""
    monkeypatch.setattr(tdp, "available_workers", lambda n=None: 1)
    files = write_clip_files(clip, str(tmp_path))
    with recording() as rec:
        got = _Problem()
        T.track_frames(got, clip.lens, files.video_path, 0, 9, block=BLOCK, device="cpu")
    s = rec.summary()
    for name in ("track.decode_wait", "track.stack", "track.upload", "track.pyramid",
                 "track.lk", "track.emit"):
        assert s[name]["calls"] >= 3, name
    assert s["track.block"]["counts"] == {"pairs": 9, "lk_edge_points": 0}
    assert len(got.calls) == 9
    by_id = {r.id: r for r in rec.records}
    for r in rec.records:
        if r.name in ("track.decode_wait", "track.stack", "track.upload", "track.emit"):
            assert by_id[r.parent].name == "track.block"


def test_coarse_stage_spans_nest_under_track_coarse(clip):
    """The coarse stage's two steps are children of `track.coarse`, in
    order; the LK levels open no span of their own."""
    with recording() as rec:
        T.track_clip(_Problem(), clip.lens, clip.frames, clip.frame_ts, RANGES, block=BLOCK)
    coarse = [r for r in rec.records if r.name == "track.coarse"]
    assert len(coarse) == 3
    for c in coarse:
        kids = _children(rec, c.id)
        assert [k.name for k in kids] == ["coarse.global", "coarse.volume"]
        assert all(c.start_ns <= k.start_ns <= k.end_ns <= c.end_ns for k in kids)
    assert all(not _children(rec, r.id) for r in rec.records if r.name == "track.lk")


def _smooth_texture(shape, seed):
    """Texture smooth enough at the entry level (sigma 16 px) for LK to
    run far from its guess."""
    from scipy.ndimage import gaussian_filter

    img = gaussian_filter(np.random.default_rng(seed).normal(size=shape), 16.0)
    return (img - img.min()) * 255.0 / (img.max() - img.min())


def test_lk_edge_points_equal_a_direct_count_and_reads_stay_three(clip, monkeypatch):
    """`lk_edge_points` on each track.block is the count, over the pairs
    it emits, of points whose entry-level LK iterate ended more than
    margin - 2 px from its guess, taken directly from the iterates: here
    a textured pair moved (3, -2) px, with the coarse stage's guess put
    30 px (7.5 entry-level px) off for every other point, so LK runs to
    its margin there. The count rides on the tracked points' read: 2
    host reads a block, and one for the grid's rays, read once before
    the blocks."""
    img = _smooth_texture((300, 380), 4)
    a, b = img[20:260, 20:340], img[22:262, 17:337]  # b(x) = a(x - (3, -2))
    frames = torch.as_tensor(np.stack([a, b] * 5).round().astype(np.uint8))
    orig_coarse, orig_iter = T._coarse_init, T._lk_iterate

    def off_coarse(*args, **kw):
        d = orig_coarse(*args, **kw).clone()
        d[:, ::2, 0] += 30.0
        return d

    direct = []

    def spy(img_b, pts_level, guess, tmpl, radius, iters, margin, fidx=None, edges=False):
        out = orig_iter(img_b, pts_level, guess, tmpl, radius, iters, margin, fidx=fidx,
                        edges=edges)
        if edges:
            rel = out[0] - guess
            direct.append(torch.sum(torch.amax(torch.abs(rel), dim=-1) > margin - 2.0, dim=-1))
        return out

    monkeypatch.setattr(T, "_coarse_init", off_coarse)
    monkeypatch.setattr(T, "_lk_iterate", spy)
    with recording() as rec:
        T.track_clip(_Problem(), clip.lens, frames, np.arange(10) / 30.0, RANGES, block=BLOCK)
    blocks = sorted((r for r in rec.records if r.name == "track.block" and r.counts),
                    key=lambda r: r.start_ns)
    assert len(direct) == len(blocks) == 3
    want = [int(d[: blk.counts["pairs"]].sum()) for d, blk in zip(direct, blocks)]
    assert [blk.counts["lk_edge_points"] for blk in blocks] == want
    assert min(want) > 0  # up to half of each pair's 35 points
    reads = [r for r in rec.records if r.counts.get("host_reads")]
    for blk in blocks:
        assert sum(r.counts["host_reads"] for r in reads
                   if blk.start_ns <= r.start_ns <= blk.end_ns) == 2
    assert rec.counted("host_reads") == 2 * len(blocks) + 1


def test_lk_edge_points_read_0_on_a_60fps_pair():
    """One of the fastest pairs of hero6-60.clip's scene (seed
    2200000304, 60 fps, pair 1260: up to 62 px off the median flow),
    rendered at 2704x2028: every point ends inside its entry margin."""
    from portbench.gen import synthclip

    W, H, fps = 2704, 2028, 60.0
    lens = synthclip.hero6_lens(W, H, 0.01111)
    frames = synthclip.render_frames(2200000304, [1260, 1261], fps, W, H, lens.ro, "cpu", lens)
    with recording() as rec:
        T.track_clip(_Problem(), tlens.Lens(**vars(lens)), frames, np.array([1260, 1261]) / fps,
                     grid_step=200, block=1)
    (blk,) = [r for r in rec.records if r.name == "track.block" and r.counts]
    assert blk.counts == {"pairs": 1, "lk_edge_points": 0}
    assert rec.counted("host_reads") == 3


# ---------------------------------------------------------------------------
# the Sync loop's spans


@pytest.fixture(scope="module")
def sync_problem():
    """test_torch_mesh.py's batch: make_scene seed 9, 4 windows."""
    from synthetic import make_scene

    scene = make_scene(seed=9, true_delay=0.011, n_frames=16, n_points=40)
    table = make_spline_table(scene.quats_wxyz, scene.gyro_rate, device="cpu")
    frames = sorted(scene.frames)

    def win(f0, f1):
        sel = [f for f in frames if f0 <= f <= f1]
        return build_track_window(*[[scene.frames[f][k] for f in sel] for k in range(4)],
                                  quats_start=float(scene.gyro_ts[0]),
                                  sample_rate=scene.gyro_rate, device="cpu")

    wins = B.stack_windows([win(*s) for s in [(0, 3), (4, 7), (8, 11), (12, 15)]])
    return scene, table, wins


def _presync_then_sync(table, wins, motion_opt):
    grid = torch.tensor(np.arange(-0.05, 0.05, 0.002), dtype=torch.float32)
    _, best = B.batched_presync(table, wins, grid, torch.Generator().manual_seed(3))
    res = B.batched_sync(table, wins, best, best, 0.2, torch.Generator().manual_seed(5),
                         motion_opt)
    return best, res


@pytest.mark.parametrize("motion_opt", ["irls", "lbfgs"])
def test_batched_sync_spans_counts_and_delays_bit_equal(sync_problem, motion_opt):
    _, table, wins = sync_problem
    best_off, res_off = _presync_then_sync(table, wins, motion_opt)
    with recording() as rec:
        best_on, res_on = _presync_then_sync(table, wins, motion_opt)
    assert torch.equal(best_on, best_off)
    for x, y in zip(res_on, res_off):
        assert torch.equal(torch.nan_to_num(x, nan=-7.0), torch.nan_to_num(y, nan=-7.0))

    (init,) = [r for r in rec.records if r.name == "sync.init"]
    (loop,) = [r for r in rec.records if r.name == "sync.loop"]
    assert init.parent is None and loop.parent is None and init.end_ns <= loop.start_ns
    trips = int(res_on.iterations.max())
    assert 0 < trips < 200 and loop.counts == {"outer_iters": trips}
    kids = _children(rec, loop.id)
    assert [k.name for k in kids] == ["sync.done", "sync.motion", "sync.step"] * trips + [
        "sync.done"]
    assert all(k.counts == {"host_reads": 1} for k in kids if k.name == "sync.done")
    motion = [k for k in kids if k.name == "sync.motion"]
    lbfgs_reads = sum(k.counts.get("host_reads", 0) for k in motion)
    if motion_opt == "irls":
        assert lbfgs_reads == 0 and rec.counted("lbfgs.trips") == 0
    else:
        trips_lbfgs = rec.counted("lbfgs.trips")
        assert trips_lbfgs >= int(res_on.motion_iterations.max()) > 0
        # the loop's test before each trip and the one that ends it, and
        # one before each line-search trial and after its last
        assert lbfgs_reads >= trips_lbfgs + len(motion)
    assert rec.counted("host_reads") == trips + 1 + lbfgs_reads
