"""The tracker block as CUDA graph replays (rssync_tpu_torch/frontend/tracking.py).

`_track_blocks` makes the grid's device forms (`grid_forms`: the float32
points, each fine level's points and static-template index) and the
grid's rays once a call, so no block copies the grid from the host. On a
card (`-m cuda`) each block is a replay of the `_BlockGraph` captured for
its shape, one graph a stage, whose tracks, rays and edge counts must be
bit-equal to the eager block's (reached through the private predicate
`_use_block_graph`). On the CPU the block stays eager: the forms give the
host grid's patches and tracks bit for bit, and the graph's stages run
by hand give `lk_track_video`'s block. No JAX here: the card tests run
in this file.

    python -m pytest --noconftest -m cuda tests/test_torch_track_graph.py
"""

import numpy as np
import pytest
import torch

from rssync_tpu_torch.frontend import decode_pool as tdp
from rssync_tpu_torch.frontend import tracking as T
from rssync_tpu_torch.ops import lens as tlens
from rssync_tpu_torch.ops import strips as ST
from rssync_tpu_torch.testing.synthvideo import make_clip, write_clip_files
from rssync_tpu_torch.utils import timing
from rssync_tpu_torch.utils.graphs import GRAPHS_PER_DEVICE, GraphCache
from rssync_tpu_torch.utils.timing import recording

torch.set_num_threads(2)

GRAPH_COUNTS = ("track.graph_captures", "track.graph_replays")


class _Problem:
    """Stands in for a SyncProblem: keeps what set_track_result gets."""

    def __init__(self):
        self.calls = {}

    def set_track_result(self, frame, *data):
        assert frame not in self.calls
        self.calls[frame] = data


def _assert_calls_equal(a: _Problem, b: _Problem):
    assert sorted(a.calls) == sorted(b.calls) and a.calls
    for f, data in a.calls.items():
        for x, y in zip(data, b.calls[f]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _textured(rng, n, h, w, shift=(2, -1)):
    """n frames of smooth texture, each moved by `shift` px from the last."""
    from scipy.ndimage import gaussian_filter

    big = gaussian_filter(rng.normal(size=(h + 8 * n, w + 8 * n)), 3.0)
    big = (big - big.min()) * 255.0 / (big.max() - big.min())
    dx, dy = shift
    x0, y0 = 4 * n, 4 * n
    return np.stack([big[y0 + i * dy : y0 + i * dy + h, x0 + i * dx : x0 + i * dx + w]
                     for i in range(n)]).round().astype(np.uint8)


# ---------------------------------------------------------------------------
# the CPU: the forms, and the block eager


@pytest.mark.parametrize("hw,step", [((2028, 2704), 200), ((1080, 1920), None),
                                     ((241, 333), 40)])
def test_patch_index_gives_extract_patches_statics_patches(hw, step):
    """Each fine level's template index in the forms gathers the patches
    `_extract_patches_static` cuts at the host grid, from images of that
    level's storage dims; a level whose points are not whole numbers
    (1920 wide: a step of 142 px, 35.5 at level 2) has none."""
    H, W = hw
    pts = T.grid_points(W, H, step)
    levels = T.auto_levels(H, W)
    grid = T.grid_forms(pts, hw, levels, T.LK_RADIUS, T.LK_ITERS, "cpu")
    host = np.asarray(pts, np.float32)
    rng = np.random.default_rng(H)
    indexed = 0
    for lvl, _it, _m, r in T._fine_plan(levels, T.LK_ITERS, T.LK_RADIUS):
        pts_l, index = grid.levels[lvl]
        p = host / float(2**lvl)
        np.testing.assert_array_equal(pts_l.numpy(), p)
        if not np.all(p == np.round(p)):
            assert index is None
            continue
        indexed += 1
        imgs = torch.as_tensor(rng.integers(0, 256, (2, *index[2]), dtype=np.uint8))
        want = T._extract_patches_static(imgs, p - (r + 1), 2 * r + 3)
        assert torch.equal(T._gather_patches(imgs, index), want)
        with pytest.raises(ValueError, match="patch index"):
            T._gather_patches(imgs[:, 1:], index)
    assert indexed >= 1


@pytest.mark.parametrize("case", ["whole", "half_px_at_level_2", "deep"])
def test_lk_track_video_with_grid_forms_equals_the_host_grid(case):
    """lk_track_video given the grid's forms tracks bit-equal to the call
    given the host grid, edge counts too, and both equal lk_track_pairs,
    whose device points take the dynamic templates (bilinear patches at
    whole-pixel origins are the gathered ones)."""
    H, W, n, step = {"whole": (240, 320, 4, 40), "half_px_at_level_2": (240, 320, 4, 30),
                     "deep": (768, 1024, 3, 128)}[case]
    frames = torch.as_tensor(_textured(np.random.default_rng(5), n, H, W))
    pts = T.grid_points(W, H, step)
    levels = T.auto_levels(H, W)
    grid = T.grid_forms(pts, (H, W), levels, T.LK_RADIUS, T.LK_ITERS, "cpu")
    assert (levels >= T.DEEP_LEVELS) == (case == "deep")
    assert (grid.levels[2][1] is None) == (case == "half_px_at_level_2")
    want, want_edge = T.lk_track_video(frames, pts, edges=True)
    got, got_edge = T.lk_track_video(frames, grid, edges=True)
    assert torch.equal(got, want) and torch.equal(got_edge, want_edge)
    pairs = T.lk_track_pairs(frames[:-1], frames[1:], torch.as_tensor(pts, dtype=torch.float32))
    assert torch.equal(pairs, want)


def test_track_blocks_copy_no_grid_from_the_host():
    """Every tensor `_track_blocks` makes from a host array (the grid's
    forms) is made in `track.grid`, before the first block: none while a
    `track.block` is open. The call before warms the pyramid's weights."""
    clip = make_clip(seed=3, n_frames=10, width=320, height=240, fps=30.0, device="cpu")
    T.track_clip(_Problem(), clip.lens, clip.frames, clip.frame_ts, block=4)
    made = []
    real = {name: getattr(torch, name) for name in ("as_tensor", "from_numpy", "tensor")}

    def spy(name):
        def make(data, *a, **k):
            if isinstance(data, np.ndarray):
                made.append([r.name for r in timing._active._stack()])
            return real[name](data, *a, **k)
        return make

    with pytest.MonkeyPatch.context() as mp:
        for name in real:
            mp.setattr(torch, name, spy(name))
        with recording() as rec:
            T.track_clip(_Problem(), clip.lens, clip.frames, clip.frame_ts, block=4)
    # 3 blocks pulled, the last 2 drained alone
    assert len([r for r in rec.records if r.name == "track.block"]) == 5
    assert made and all(stack[:1] == ["track.grid"] for stack in made)


@pytest.mark.parametrize("hw,n", [((240, 320), 5), ((768, 1024), 3)])
def test_block_graph_stages_give_the_eager_block(hw, n):
    """The `_BlockGraph`'s stages (pyramid, coarse, LK levels), run by
    hand in order over its static stack, give lk_track_video's tracks and
    edge counts on the same block, bit for bit."""
    H, W = hw
    levels = T.auto_levels(H, W)
    frames = torch.as_tensor(T.pad_frames_host(_textured(np.random.default_rng(7), n, H, W)))
    grid = T.grid_forms(T.grid_points(W, H), hw, levels, T.LK_RADIUS, T.LK_ITERS, "cpu")
    bg = T._BlockGraph(frames, grid, hw, levels)
    assert [name for name, _ in bg.stages] == ["track.pyramid", "track.coarse", "track.lk"]
    bg.block.stack.copy_(frames)
    for _name, stage in bg.stages:
        stage(bg.block)
    want = T.lk_track_video(frames, grid, logical_hw=hw, edges=True)
    for x, y in zip(bg.block.out, want):
        assert torch.equal(x, y)


def test_cpu_blocks_stay_eager():
    """On the CPU no block is a graph: no graph count, no capture span."""
    clip = make_clip(seed=4, n_frames=8, width=320, height=240, fps=30.0, device="cpu")
    assert not T._use_block_graph(clip.frames)
    with recording() as rec:
        T.track_clip(_Problem(), clip.lens, clip.frames, clip.frame_ts, block=4)
    assert all(rec.counted(c) == 0 for c in GRAPH_COUNTS)
    assert not [r for r in rec.records if r.name == "track.capture"]


def test_graph_cache_keeps_the_last_entries_used_a_device():
    """An entry is made once a key and device and found again; a device
    keeps the last GRAPHS_PER_DEVICE used, the least recently used
    dropped first; devices do not share entries."""
    cache, made = GraphCache(), []

    def use(dev, key):
        with cache.use(torch.device(dev), key, lambda: made.append(key) or [key]) as entry:
            return entry

    first = use("cpu", 0)
    assert use("cpu", 0) is first and made == [0]
    for key in range(1, GRAPHS_PER_DEVICE):
        use("cpu", key)
    use("cpu", 0)  # now the most recently used
    use("cpu", GRAPHS_PER_DEVICE)
    assert list(cache[torch.device("cpu")][1]) == [*range(2, GRAPHS_PER_DEVICE), 0,
                                                   GRAPHS_PER_DEVICE]
    use("meta", 0)
    assert made == [*range(GRAPHS_PER_DEVICE + 1), 0]


def test_captured_launches_count_at_each_replay():
    """K3 launches a capture records are kept per thread, out of LAUNCHES
    (they run nothing); `count_replay` counts them and their shapes a
    run; a tally nested in another restores the outer one."""
    import threading

    ST.reset_launch_counters()
    shape = (17, 2072, 2816, 16, 130, "torch.uint8")
    seen = []
    with ST.captured_launches() as outer:
        with ST.captured_launches() as inner:
            assert ST._CAPTURE.tally is inner
            other = threading.Thread(target=lambda: seen.append(getattr(ST._CAPTURE, "tally",
                                                                        None)))
            other.start()
            other.join()
        assert ST._CAPTURE.tally is outer is not inner
    assert seen == [None] and ST._CAPTURE.tally is None
    assert ST.LAUNCHES["gather_strips"] == 0
    for _ in range(2):
        ST.count_replay([shape, shape])
    assert ST.LAUNCHES["gather_strips"] == 4 and ST.LAUNCH_SHAPES["gather_strips"] == {shape}
    ST.reset_launch_counters()


def test_emission_with_grid_forms_equals_the_host_grid():
    """emit_track_block given the grid's forms feeds the same rays and
    times as given the host grid; the forms lift the grid once a lens."""
    clip = make_clip(seed=5, n_frames=5, width=320, height=240, fps=30.0, device="cpu")
    pts = T.grid_points(320, 240)
    tracked = T.lk_track_video(clip.frames)
    grid = T.grid_forms(pts, (240, 320), T.auto_levels(240, 320), T.LK_RADIUS, T.LK_ITERS,
                        "cpu")
    want, got = _Problem(), _Problem()
    T.emit_track_block(want, clip.lens, pts, tracked, np.arange(4), clip.frame_ts, 240)
    with recording() as rec:
        T.emit_track_block(got, clip.lens, grid, tracked, np.arange(4), clip.frame_ts, 240)
        T.emit_track_block(_Problem(), clip.lens, grid, tracked, np.arange(4), clip.frame_ts,
                           240)
    _assert_calls_equal(got, want)
    # the grid's lift and read once, then one lift and two reads a block
    assert rec.summary()["emit.lift"]["calls"] == 3
    assert rec.counted("host_reads") == 5
    other = tlens.Lens(ro=0.01, fx=150.0, fy=150.0, cx=160.0, cy=120.0)
    np.testing.assert_array_equal(
        grid.rays(other),
        tlens.lift_points(other, torch.as_tensor(pts, dtype=torch.float32)).double().numpy())


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _hero6_frames(fps: float, n: int, device):
    """n consecutive frames of hero6-60.clip's / hero6-30.clip's scene
    (seed 2200000304) at 2704x2028, from frame 1116, and their lens."""
    from portbench.gen import synthclip

    W, H = 2704, 2028
    lens = synthclip.hero6_lens(W, H, 0.01111)
    idx = np.arange(1116, 1116 + n)
    frames = synthclip.render_frames(2200000304, idx.tolist(), fps, W, H, lens.ro, device, lens)
    return tlens.Lens(**vars(lens)), frames, idx / fps


def _tracked(lens, frames, ts, monkeypatch, graphed: bool, record: bool = True):
    """track_clip's calls, recording and K3 launches, eager or graphed."""
    monkeypatch.setattr(T, "_use_block_graph", lambda stack: graphed and stack.is_cuda)
    got = _Problem()
    k3 = ST.LAUNCHES["gather_strips"]
    if record:
        with recording() as rec:
            T.track_clip(got, lens, frames, ts, grid_step=200)
    else:
        rec = None
        T.track_clip(got, lens, frames, ts, grid_step=200)
    torch.cuda.synchronize()
    return got, rec, ST.LAUNCHES["gather_strips"] - k3


def _edge_points(rec) -> list:
    return [r.counts["lk_edge_points"] for r in sorted(rec.records, key=lambda r: r.start_ns)
            if r.name == "track.block" and "lk_edge_points" in r.counts]


@pytest.mark.cuda
@pytest.mark.parametrize("fps", [60.0, 30.0])
def test_graphed_blocks_equal_eager_on_card(cuda, monkeypatch, fps):
    """21 pairs at 2704x2028 (a block of 16, then a tail of 5 filled up
    to 16) at the cells' motion: the graphed track_clip feeds rays and
    times bit-equal to the eager one's, with equal edge counts a block.
    A fresh key captures once (three stage graphs); a second call
    captures nothing and replays three graphs a block; an unrecorded
    call replays the same graphs to the same tracks; K3's launch count
    rises on a replay as on the eager path (the first call counts its
    eager warm-up block and its replays, not the captures, which run
    nothing), and its shapes are recorded again after the counters are
    reset."""
    monkeypatch.setattr(T, "_BLOCK_GRAPHS", GraphCache())
    lens, frames, ts = _hero6_frames(fps, 22, cuda)
    eager, rec_e, k3_e = _tracked(lens, frames, ts, monkeypatch, graphed=False)
    first, rec_1, k3_1 = _tracked(lens, frames, ts, monkeypatch, graphed=True)
    second, rec_2, k3_2 = _tracked(lens, frames, ts, monkeypatch, graphed=True)
    ST.reset_launch_counters()
    quiet, _, k3_q = _tracked(lens, frames, ts, monkeypatch, graphed=True, record=False)
    for got in (first, second, quiet):
        _assert_calls_equal(got, eager)
    assert len(eager.calls) == 21
    assert _edge_points(rec_1) == _edge_points(rec_2) == _edge_points(rec_e)
    assert all(rec_e.counted(c) == 0 for c in GRAPH_COUNTS)
    assert rec_1.counted("track.graph_captures") == 1
    assert rec_2.counted("track.graph_captures") == 0
    assert rec_1.counted("track.graph_replays") == rec_2.counted("track.graph_replays") == 2 * 3
    assert len([r for r in rec_1.records if r.name == "track.capture"]) == 1
    assert k3_e > 0 and k3_2 == k3_q == k3_e
    (bg,) = T._BLOCK_GRAPHS[frames.device][1].values()
    assert len(bg.k3) * 2 == k3_e and k3_1 == len(bg.k3) * 3
    assert ST.LAUNCH_SHAPES["gather_strips"] == set(bg.k3) != set()


@pytest.mark.cuda
def test_track_frames_equals_track_clip_on_card(cuda, tmp_path, monkeypatch):
    """track_frames (decoded blocks uploaded from pinned memory into the
    graph's static stack) feeds the same rays and times as the graphed
    and the eager track_clip on the decoded frames, 19 pairs at 640x480
    (a block of 16 and a tail of 3)."""
    monkeypatch.setattr(tdp, "available_workers", lambda n=None: 1)
    clip = make_clip(seed=6, n_frames=20, width=640, height=480, fps=30.0, device=cuda)
    files = write_clip_files(clip, str(tmp_path))
    src = T.VideoSource(files.video_path)
    decoded = list(src.frames(0, 20))
    src.close()
    frames = torch.as_tensor(np.stack([f.gray for f in decoded]), device=cuda)
    ts = np.asarray([f.timestamp for f in decoded])
    got = _Problem()
    with recording() as rec:
        T.track_frames(got, clip.lens, files.video_path, 0, 19, device=cuda)
    assert rec.counted("track.graph_replays") == 2 * 3
    graphed, eager = _Problem(), _Problem()
    T.track_clip(graphed, clip.lens, frames, ts)
    monkeypatch.setattr(T, "_use_block_graph", lambda stack: False)
    T.track_clip(eager, clip.lens, frames, ts)
    assert len(got.calls) == 19
    _assert_calls_equal(got, graphed)
    _assert_calls_equal(got, eager)
