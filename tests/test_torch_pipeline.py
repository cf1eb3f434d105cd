"""The port's recipe pipeline (rssync_tpu_torch/pipeline/, its video
decode in frontend/tracking.py and frontend/decode_pool.py, and its CLI)
held to rssync_tpu's on one rendered clip: rssync_tpu's make_clip
writes the mp4, the .gcsv gyro log and the lens file, rssync_tpu's
run_recipe syncs it once as the reference, and the port runs the same
recipe on the CPU.

Decoded frames must be bit-identical (the same cv2 decode); the tracks
of `track_frames` must equal `track_clip`'s on the same frames bit for
bit; delays agree with rssync_tpu's within 0.1 ms (float32
optimizations of the same loss from different RANSAC draws) and with
the truth within 0.5 ms.
"""

import json

import numpy as np
import pytest
import torch

from rssync_tpu_torch.frontend import decode_pool as tdp
from rssync_tpu_torch.frontend import tracking as T
from rssync_tpu_torch.frontend.lens_profiles import load_lens_profile
from rssync_tpu_torch.pipeline import recipe as R

torch.set_num_threads(2)

TRUTH_TOL_MS, JAX_TOL_MS = 0.5, 0.1
#: batched vs sequential Sync (different RANSAC draws), ms
SEQ_TOL_MS = 0.05
#: the loss surface's minimum vs the truth, s
SURFACE_TOL_S = 0.005


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """tests/test_pipeline.py's clip: 640x480, 26 frames at 30 fps."""
    pytest.importorskip("jax")
    from rssync_tpu.testing.synthvideo import make_clip

    return make_clip(str(tmp_path_factory.mktemp("clip")), seed=2, true_delay=0.0213,
                     n_frames=26, fps=30.0, width=640, height=480, pad=1.0)


def make_recipe(clip, out_dir, **over):
    """tests/test_pipeline.py's recipe, with gyroflow offsets in the CSV."""
    r = {
        "input": {
            "video_path": clip.video_path,
            "gyro_path": clip.gyro_path,
            "gyro_orientation": clip.orient,
            "frame_range": [0, 25],
            "lens_profile": {"type": "file", "path": clip.lens_path, "name": clip.lens_name},
            "initial_guess": 500.0,
            "use_simple_presync": True,
            "simple_presync_radius": 80.0,
            "simple_presync_step": 2.0,
        },
        "params": {"sync_window": 8, "syncpoints_format": "auto", "syncpoint_distance": 8},
        "output": {
            "csv_path": str(out_dir / "sync.csv"),
            "debug_csv_path": str(out_dir / "debug.csv"),
            "gyroflow_offsets": True,
        },
    }
    for k, v in over.items():
        sec, key = k.split("__")
        r[sec][key] = v
    return r


@pytest.fixture(scope="module")
def jax_run(clip, tmp_path_factory):
    """rssync_tpu's batched run_recipe on the clip (JAX on the CPU)."""
    from rssync_tpu.pipeline.recipe import run_recipe

    return run_recipe(make_recipe(clip, tmp_path_factory.mktemp("jax")), batched=True, seed=0)


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("track_cache"))


@pytest.fixture(scope="module")
def port_run(clip, tmp_path_factory, cache_dir):
    """The port's batched run_recipe on the CPU; its tracks fill the
    module's track cache, from which the later runs of the same decode
    ranges read them."""
    timings = R.Timings()
    res = R.run_recipe(make_recipe(clip, tmp_path_factory.mktemp("port")), seed=0,
                       track_cache_dir=cache_dir, timings=timings, device="cpu")
    return res, timings


def _csv(path):
    return np.loadtxt(path, delimiter=",", ndmin=2)


# ---------------------------------------------------------------------------
# video decode


def _frames(it):
    return [(f.index, f.timestamp, f.gray) for f in it]


def _assert_same_frames(got, want):
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, ts_g, gray_g), (_, ts_w, gray_w) in zip(got, want):
        assert ts_g == ts_w
        assert gray_g.dtype == gray_w.dtype == np.uint8
        np.testing.assert_array_equal(gray_g, gray_w)


@pytest.mark.parametrize("raw_luma", [True, False])
def test_video_source_matches_jax(clip, raw_luma):
    """Frames, indices and timestamps equal rssync_tpu's, through a
    forward grab-skip, a backward seek and the raw-luma probe."""
    from rssync_tpu.frontend import tracking as jt

    got_src, want_src = T.VideoSource(clip.video_path, raw_luma), jt.VideoSource(
        clip.video_path, raw_luma)
    assert (got_src.fps, got_src.width, got_src.height, got_src._raw) == (
        want_src.fps, want_src.width, want_src.height, want_src._raw)
    for b, e in [(0, 5), (9, 14), (2, 6), (20, 26)]:
        _assert_same_frames(_frames(got_src.frames(b, e)), _frames(want_src.frames(b, e)))
    got_src.close()
    want_src.cap.release()


@pytest.mark.parametrize("start, stop", [(3, 21), (0, 26)])
def test_frame_feed_matches_jax(clip, start, stop, monkeypatch):
    """The single decode-ahead reader, 4-frame chunks with 2 buffered
    (backpressure), gives rssync_tpu's FrameFeed's frames with one
    worker."""
    from rssync_tpu.frontend import tracking as jt

    monkeypatch.setattr(T.FrameFeed, "CHUNK", 4)
    monkeypatch.setattr(T.FrameFeed, "AHEAD", 2)
    monkeypatch.setattr(jt.FrameFeed, "CHUNK", 4)
    got = _frames(T.FrameFeed(clip.video_path, start, stop))
    want = _frames(jt.FrameFeed(clip.video_path, start, stop, n_workers=1, ahead=2))
    assert len(got) == stop - start
    _assert_same_frames(got, want)


def test_decode_pool_matches_jax_and_serial(clip):
    """Two worker processes, 3-frame chunks and a 2-slot ring (ring
    backpressure, interleaved chunks): the same frames as rssync_tpu's
    pool and as a serial decode."""
    from rssync_tpu.frontend.decode_pool import DecodePool as JPool

    src = T.VideoSource(clip.video_path)
    spans = [(1, 9), (12, 24)]
    serial = [_frames(src.frames(b, e)) for b, e in spans]
    src.close()
    args = (clip.video_path, spans, src.height, src.width, src._raw)
    for pool_cls in (tdp.DecodePool, JPool):
        with pool_cls(*args, n_workers=2, chunk=3, slots=2) as pool:
            for i, want in enumerate(serial):
                got = [(idx, ts, g) for idx, ts, g in pool.span_frames(i)]
                _assert_same_frames(got, want)


def test_decode_pool_worker_death_raises(clip):
    """A killed worker surfaces as a RuntimeError at the consumer, never
    as a hang."""
    src = T.VideoSource(clip.video_path)
    src.close()
    with tdp.DecodePool(clip.video_path, [(0, 26)], src.height, src.width, src._raw,
                        n_workers=2, chunk=2, slots=1, worker_delay_s=0.05) as pool:
        it = pool.span_frames(0)
        next(it)
        victim = pool._procs[1]
        victim.terminate()
        victim.join(timeout=10.0)
        with pytest.raises(RuntimeError, match="died|failed|early"):
            for _ in it:
                pass


def test_probe_workers_times_a_warm_burst(clip, monkeypatch):
    """probe_workers spawns each candidate's pool once and times only
    the second burst, from the run's first frame; it caches its choice,
    and falls back to the heuristic with too few frames."""
    spans_seen, timed = [], []
    real_pool = tdp.DecodePool

    class Pool(real_pool):
        def __init__(self, path, spans, *a, **k):
            spans_seen.append(list(spans))
            super().__init__(path, spans, *a, **k)

        def span_frames(self, i):
            timed.append(i)
            return super().span_frames(i)

    monkeypatch.setattr(tdp, "DecodePool", Pool)
    monkeypatch.setattr(tdp, "_PROBE_CACHE", {})
    src = T.VideoSource(clip.video_path)
    src.close()
    args = (clip.video_path, src.height, src.width, src._raw)
    k = tdp.probe_workers(*args, max_frames=20, burst=8, candidates=[1, 2], start=4)
    assert k in (1, 2)
    assert spans_seen == [[(4, 12), (12, 20)]] * 2 and timed == [0, 1, 0, 1]
    assert tdp.probe_workers(*args, max_frames=20, burst=8, candidates=[1, 2], start=4) == k
    assert len(spans_seen) == 2  # cached
    assert tdp.probe_workers(*args, max_frames=4) == tdp.available_workers(None)


# ---------------------------------------------------------------------------
# ranges and schedules


@pytest.mark.parametrize("ranges, begin, end", [
    ([(3, 9), (0, 5), (40, 60)], 0, 50),
    ([(0, 5), (5 + 16, 30)], 0, 30),
    ([(0, 5), (5 + 17, 40)], 0, 40),
    ([(10, 4), (-3, 2), (7, 12)], 0, 11),
    ([], 0, 10),
])
def test_merge_pair_ranges_matches_jax(ranges, begin, end):
    from rssync_tpu.frontend import tracking as jt

    assert T.RANGE_MERGE_GAP == jt.RANGE_MERGE_GAP
    assert T._merge_pair_ranges(ranges, begin, end) == jt._merge_pair_ranges(ranges, begin, end)


@pytest.mark.parametrize("params, frame_range", [
    ({"sync_window": 8, "syncpoints_format": "auto", "syncpoint_distance": 8}, [0, 25]),
    ({"sync_window": 60, "syncpoint_distance": 120}, [0, 479]),
    ({"sync_window": 4, "syncpoints_format": "array", "syncpoints_array": [0, 18]}, [0, 25]),
    ({"sync_window": 8, "syncpoints_format": "array", "syncpoints_array": [4, 12]}, [2, 25]),
    ({"sync_window": 100, "syncpoints_format": "auto", "syncpoint_distance": 10}, [0, 13]),
])
def test_schedule_and_decode_ranges_match_jax(params, frame_range):
    """make_syncpoints and the decode ranges (every syncpoint window and
    the debug.csv window, then merged) equal rssync_tpu's, the case of
    test_pipeline.py's decode-scope test included."""
    pytest.importorskip("jax")
    from rssync_tpu.frontend import tracking as jt
    from rssync_tpu.pipeline import recipe as jr

    recipe = {"input": {"frame_range": frame_range}, "params": params}
    assert R.make_syncpoints(params, *frame_range) == jr.make_syncpoints(params, *frame_range)
    got = R._window_pair_ranges(recipe)
    assert got == jr._window_pair_ranges(recipe)
    assert got[-1] == (frame_range[0], frame_range[0] + params["sync_window"] + 1)
    for gap in (T.RANGE_MERGE_GAP, 0):
        assert (T._merge_pair_ranges(got, *frame_range)
                == jt._merge_pair_ranges(got, *frame_range))


def test_stack_pad_host_equals_device_pad():
    """The host's one-copy pad of a short block (last frame repeated)
    equals the device path's _pad_lanes of the same frames, bit for bit,
    also when written into a given buffer."""
    rng = np.random.default_rng(4)
    grays = list(rng.integers(0, 256, (5, 123, 201)).astype(np.uint8))
    idx = torch.tensor([0, 1, 2, 3, 4, 4, 4])
    for fine in (True, False):
        want = T._pad_lanes(torch.as_tensor(np.stack(grays))[idx], fine).numpy()
        Hp, Wp = want.shape[1:]
        np.testing.assert_array_equal(T.stack_pad_host(grays, 7, 123, 201, Hp, Wp), want)
        out = np.full((7, Hp, Wp), 7, np.uint8)
        assert T.stack_pad_host(grays, 7, 123, 201, Hp, Wp, out=out) is out
        np.testing.assert_array_equal(out, want)


class _Recorder:
    def __init__(self):
        self.calls = {}

    def set_track_result(self, frame, *data):
        assert frame not in self.calls
        self.calls[frame] = data


@pytest.mark.parametrize("ranges, gap, workers", [
    ([(0, 9), (16, 25)], 0, None), ([(2, 7), (9, 21)], 16, 1)])
def test_track_frames_equals_track_clip(clip, ranges, gap, workers, monkeypatch):
    """track_frames (decode through the decoder pool, or the FrameFeed
    thread with one worker; host pad, upload, lk_track_video in blocks,
    emit_track_block) gives bit-identical frame data to track_clip on the
    decoded frames and their timestamps over the same (merged) ranges,
    short tail blocks included."""
    monkeypatch.setattr(T, "RANGE_MERGE_GAP", gap)
    if workers is not None:
        monkeypatch.setattr(tdp, "available_workers", lambda n=None: workers)
    lens = load_lens_profile(clip.lens_path, clip.lens_name)
    src = T.VideoSource(clip.video_path)
    decoded = _frames(src.frames(0, 26))
    src.close()
    frames = torch.as_tensor(np.stack([f[2] for f in decoded]))
    ts = np.asarray([f[1] for f in decoded])
    got, want = _Recorder(), _Recorder()
    T.track_frames(got, lens, clip.video_path, 0, 25, ranges=ranges, block=4, device="cpu")
    merged = T._merge_pair_ranges(ranges, 0, 25)
    T.track_clip(want, lens, frames, ts, merged, block=4)
    assert sorted(got.calls) == sorted(want.calls) == [
        p for b, e in merged for p in range(b, e)]
    for f, data in want.calls.items():
        for x, y in zip(got.calls[f], data):
            assert x.dtype == y.dtype == np.float64
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# run_recipe


def test_run_recipe_batched_matches_jax(clip, port_run, jax_run):
    res, timings = port_run
    assert res.syncpoints == jax_run.syncpoints == [0, 8, 16]
    got, want = np.asarray(res.delays_ms), np.asarray(jax_run.delays_ms)
    assert np.abs(got - 1000.0 * clip.true_delay).max() < TRUTH_TOL_MS
    assert np.abs(got - want).max() < JAX_TOL_MS
    rows, ref_rows = _csv(res.csv_path), _csv(jax_run.csv_path)
    assert rows.shape == ref_rows.shape == (3, 3)
    np.testing.assert_array_equal(rows[:, 0], [0, 8, 16])
    np.testing.assert_allclose(rows[:, 1], res.delays_ms, rtol=1e-5)
    dbg, ref_dbg = _csv(res.debug_csv_path), _csv(jax_run.debug_csv_path)
    assert dbg.shape == ref_dbg.shape == (200, 2)
    np.testing.assert_allclose(dbg[:, 0], ref_dbg[:, 0], rtol=0, atol=1e-6)
    assert abs(dbg[np.argmin(dbg[:, 1]), 0] - clip.true_delay) < SURFACE_TOL_S
    assert set(timings.stages) == {"gyro_ingest", "tracking", "debug_presync", "sync_all"}


def test_gyroflow_offsets_match_jax(clip, port_run, jax_run):
    """The third CSV column is rssync_tpu's conversion of the port's own
    delays, and within the delays' tolerance of rssync_tpu's column."""
    from rssync_tpu.analysis.metrics import to_gyroflow_offset

    res, _ = port_run
    rows, ref_rows = _csv(res.csv_path), _csv(jax_run.csv_path)
    ro = load_lens_profile(clip.lens_path, clip.lens_name).ro
    want = [float(f"{1000.0 * to_gyroflow_offset(d / 1000.0, ro):g}") for d in res.delays_ms]
    np.testing.assert_array_equal(rows[:, 2], want)
    assert np.abs(rows[:, 2] - ref_rows[:, 2]).max() < JAX_TOL_MS


def test_sequential_matches_batched(clip, port_run, cache_dir, tmp_path):
    """The sequential control flow (pre_sync + 4 x sync per syncpoint)
    agrees with the batched run. One run of either differs from another
    seed's by RANSAC noise alone: on this clip's tracks, 40 seeds of
    sequential Sync spread over 0.064 ms at window 8 in the port and over
    0.092 ms in rssync_tpu (tests/torch_seed_spread.py). So the
    per-window means over seeds 0-3 of both modes are compared, at the
    tolerance of test_pipeline.py's single-run comparison."""
    seeds = range(4)
    out = {}
    for batched in (True, False):
        runs = [port_run[0].delays_ms] if batched else []
        for seed in seeds[len(runs):]:
            recipe = make_recipe(clip, tmp_path)
            recipe["output"]["debug_csv_path"] = ""
            res = R.run_recipe(recipe, batched=batched, seed=seed, track_cache_dir=cache_dir,
                               device="cpu")
            assert res.syncpoints == [0, 8, 16]
            runs.append(res.delays_ms)
        out[batched] = np.asarray(runs)
    assert np.abs(out[False] - 1000.0 * clip.true_delay).max() < TRUTH_TOL_MS
    assert np.abs(out[False].mean(0) - out[True].mean(0)).max() < SEQ_TOL_MS


def test_recipe_from_file_and_dis(clip, tmp_path):
    p = tmp_path / "recipe.json"
    p.write_text(json.dumps(make_recipe(clip, tmp_path)))
    res = R.run_recipe(str(p), method="dis", device="cpu")
    assert res.syncpoints == [0, 8, 16]
    assert np.abs(np.asarray(res.delays_ms) - 1000.0 * clip.true_delay).max() < TRUTH_TOL_MS


def test_syncpoints_array_mode(clip, tmp_path):
    res = R.run_recipe(make_recipe(clip, tmp_path, params__syncpoints_format="array",
                                   params__syncpoints_array=[4, 12]), device="cpu")
    assert res.syncpoints == [4, 12]
    assert np.abs(np.asarray(res.delays_ms) - 1000.0 * clip.true_delay).max() < TRUTH_TOL_MS


def test_empty_schedule_writes_empty_csv(clip, cache_dir, tmp_path):
    """A sync_window that does not fit the frame range: no syncpoints,
    an empty CSV, and no crash (test_edgecases.py's case)."""
    recipe = make_recipe(clip, tmp_path, params__sync_window=100,
                         params__syncpoint_distance=10)
    recipe["output"]["debug_csv_path"] = ""
    res = R.run_recipe(recipe, track_cache_dir=cache_dir, device="cpu")
    assert res.syncpoints == [] and res.delays_ms == []
    assert (tmp_path / "sync.csv").read_text() == ""


def test_track_cache_hit_gives_the_same_csv(clip, port_run, cache_dir, tmp_path, monkeypatch):
    """The module's first run filled the cache; a second run of the same
    recipe reads its tracks (nothing decodes) and writes the same CSV."""
    res, _ = port_run

    def no_tracking(*a, **k):
        raise AssertionError("the track cache was not hit")

    monkeypatch.setattr(T, "track_frames", no_tracking)
    again = R.run_recipe(make_recipe(clip, tmp_path), seed=0, track_cache_dir=cache_dir,
                         device="cpu")
    assert (tmp_path / "sync.csv").read_text() == open(res.csv_path).read()
    assert again.delays_ms == res.delays_ms


def test_decode_scope_full_matches_windows(clip, tmp_path, monkeypatch):
    """decode_scope="windows" skips inter-window frames and writes the
    same CSV and debug.csv as the full decode (test_pipeline.py's case:
    windows [0, 4] and [18, 22], ranges kept apart)."""
    monkeypatch.setattr(T, "RANGE_MERGE_GAP", 0)
    over = dict(params__sync_window=4, params__syncpoints_format="array",
                params__syncpoints_array=[0, 18])
    out = {}
    for scope in ("windows", "full"):
        d = tmp_path / scope
        d.mkdir()
        res = R.run_recipe(make_recipe(clip, d, **over), seed=0, decode_scope=scope,
                           device="cpu")
        assert res.syncpoints == [0, 18]
        out[scope] = [(d / n).read_text() for n in ("sync.csv", "debug.csv")]
    assert out["windows"] == out["full"]
    assert len(out["full"][1].splitlines()) == 200


def test_cli_prints_the_csv_and_the_trace(clip, port_run, cache_dir, tmp_path, capsys,
                                          monkeypatch):
    """`python -m rssync_tpu_torch.pipeline recipe.json --device cpu
    --trace`: stdout is the CSV's two columns, and stderr holds each
    window's `delay step` lines of every Sync pass, as many as the pass
    ran iterations."""
    from rssync_tpu_torch.pipeline.__main__ import main

    results = []
    real = R.sync_stage

    def recording(*a, **k):
        results.extend(real(*a, **k))
        return results[-R.SYNC_PASSES:]

    monkeypatch.setattr(R, "sync_stage", recording)
    recipe = make_recipe(clip, tmp_path)
    recipe["output"]["gyroflow_offsets"] = False
    p = tmp_path / "recipe.json"
    p.write_text(json.dumps(recipe))
    assert main([str(p), "--device", "cpu", "--trace", "--quiet", "--track-cache",
                 cache_dir]) == 0
    cap = capsys.readouterr()
    assert cap.out == (tmp_path / "sync.csv").read_text()
    assert len(results) == R.SYNC_PASSES
    lines = cap.err.splitlines()
    heads = [i for i, ln in enumerate(lines) if ln.startswith("# pass ")]
    assert len(heads) == R.SYNC_PASSES * 3
    for k, i in enumerate(heads):
        pas, w = divmod(k, 3)
        n = int(results[pas].iterations[w])
        assert lines[i] == f"# pass {pas} window {8 * w} ({n} iters)"
        body = lines[i + 1: heads[k + 1] if k + 1 < len(heads) else len(lines)]
        assert len(body) == n >= 1
        d = [float(ln.split()[0]) for ln in body]
        np.testing.assert_allclose(d, results[pas].trace_delay[w, :n].double().numpy(),
                                   rtol=1e-5)


def test_entry_points_run_on_the_card_unless_asked(clip, tmp_path):
    """run_recipe, run_multi_recipes, run_guess_orient and the CLI run on
    the card unless asked for the CPU: with no card they refuse before
    decoding anything."""
    import inspect

    from rssync_tpu_torch.pipeline.__main__ import main
    from rssync_tpu_torch.pipeline.guess_orient import run_guess_orient

    for fn in (R.run_recipe, R.run_multi_recipes, run_guess_orient, T.track_frames):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal shows only without one")
    p = tmp_path / "recipe.json"
    p.write_text(json.dumps(make_recipe(clip, tmp_path)))
    for run in (lambda: R.run_recipe(str(p)), lambda: main([str(p), "--quiet"]),
                lambda: R.run_multi_recipes([str(p), str(p)]),
                lambda: run_guess_orient(str(p)),
                lambda: main([str(p), "--guess-orient", "--quiet"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
    assert not (tmp_path / "sync.csv").exists()
