"""The Sync loop's trip as one CUDA graph (rssync_tpu_torch/core/sync.py).

On a card (`-m cuda`) `sync_loop` with IRLS motion replays one captured
graph a trip; every field of its SyncResult must be bit-equal to the
eager loop's (reached through the private predicate `_use_graph`) on the
same inputs. On the CPU the loop stays eager: it records no graph count
and keeps its spans, the graph entry's static inputs and trial steps are
the eager loop's, and the factored trip body looped by hand reproduces
`sync_loop`. No JAX here: the card tests run in this file.

    python -m pytest --noconftest -m cuda tests/test_torch_sync_graph.py
"""

import pytest
import torch

from rssync_tpu_torch.core import sync as tsync
from rssync_tpu_torch.core.sync import SyncResult
from rssync_tpu_torch.parallel import batch as B
from rssync_tpu_torch.parallel.multi import stack_tables
from rssync_tpu_torch.testing.engine_problem import OPERATING_POINT, make_engine_problem
from rssync_tpu_torch.utils.timing import recording

torch.set_num_threads(2)

GRAPH_COUNTS = ("sync.graph_captures", "sync.graph_replays")


def _bits(x: torch.Tensor) -> torch.Tensor:
    """x with floats seen as same-width integers: NaN payloads and signed
    zeros compare too."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return x.view(ints[x.dtype]) if x.dtype in ints else x


def assert_bit_equal(a: SyncResult, b: SyncResult) -> None:
    for name, x, y in zip(SyncResult._fields, a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(_bits(x), _bits(y)), name


def _problem(device, duration=60.0, seed=0, true_delay=0.0423):
    """The bench's operating point (30 windows of 60 frames x 130
    features at 60 fps), or a shorter clip of it."""
    prob = make_engine_problem(**{**OPERATING_POINT, "duration": duration, "seed": seed,
                                  "true_delay": true_delay})
    return prob, prob.table(device), B.stack_windows(prob.windows(device))


def _loop_inputs(prob, table, wins, spread_s=0.004, seed=0, radius_s=0.2):
    """sync_loop's inputs: initial delays spread about the truth,
    GuessMotion's M0 and var_k at them, centers 0 and the radius."""
    W = wins.counts.shape[0]
    dev = wins.counts.device
    d0 = prob.true_delay + torch.linspace(-spread_s, spread_s, W, device=dev)
    M0, var_k = tsync.init_motion_batched(table, wins, d0, torch.Generator(dev).manual_seed(seed))
    return d0, M0, var_k, torch.zeros(W, device=dev), torch.full((W,), radius_s, device=dev)


# ---------------------------------------------------------------------------
# the CPU: eager, as before


@pytest.fixture(scope="module")
def small_cpu():
    prob, table, wins = _problem("cpu", duration=6.0)
    return table, wins, *_loop_inputs(prob, table, wins)


@pytest.mark.parametrize("motion_opt", ["irls", "lbfgs"])
def test_cpu_loop_records_no_graph_count_and_keeps_its_spans(small_cpu, motion_opt):
    table, wins, *args = small_cpu
    assert not tsync._use_graph(args[0], motion_opt)
    with recording() as rec:
        res = tsync.sync_loop(table, wins, *args, motion_opt)
    assert all(rec.counted(c) == 0 for c in GRAPH_COUNTS)
    (loop,) = [r for r in rec.records if r.name == "sync.loop"]
    trips = int(res.iterations.max())
    assert 0 < trips < tsync.OUTER_MAX_ITERS and loop.counts == {"outer_iters": trips}
    kids = sorted((r for r in rec.records if r.parent == loop.id), key=lambda r: r.start_ns)
    assert [k.name for k in kids] == ["sync.done", "sync.motion", "sync.step"] * trips + [
        "sync.done"]
    assert not {"sync.replay", "sync.capture"} & {r.name for r in rec.records}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_graph_entry_trial_steps_are_the_eager_ones(dtype):
    W, F = 3, 5
    st = tsync._loop_start(torch.zeros(W, dtype=dtype), torch.ones(W, F, 3, dtype=dtype))
    tg = tsync._TripGraph([torch.zeros(2)] * 14, st)
    want = tsync._trial_steps(dtype, torch.device("cpu"))
    assert tg.ts.dtype == dtype and torch.equal(_bits(tg.ts), _bits(want))
    assert tg.ts.shape == (tsync.BT_MAX_ITERS,) and tg.graph is None


def test_graph_entry_holds_the_inputs_and_its_trip_is_the_eager_trip(small_cpu):
    """The entry's static table, windows and vectors after `load` are the
    call's, field by field, and a trip over them is the eager trip."""
    table, wins, d0, M0, var_k, centers, radius = small_cpu
    inputs = tsync._graph_inputs(table, wins, var_k, centers, radius)
    st = tsync._loop_start(d0, M0)
    tg = tsync._TripGraph(inputs, st)
    tg.load(inputs, st)
    assert torch.equal(tg.table.coeffs, table.coeffs)
    assert torch.equal(tg.table.sample_rate, table.sample_rate)
    for k in tsync.TrackWindow.__dataclass_fields__:
        assert torch.equal(getattr(tg.wins, k), getattr(wins, k)), k
    for x, y in ((tg.var_k, var_k), (tg.centers, centers), (tg.radius, radius)):
        assert torch.equal(x, y)
    for x, y in zip(tg.state, st):
        assert torch.equal(_bits(x), _bits(y))
    ts = tsync._trial_steps(d0.dtype, d0.device)
    want = tsync._sync_trip(table, wins, var_k, centers, radius, ts, st, "irls")
    got = tg._trip()
    for name, x, y in zip(tsync._LoopState._fields, got, want):
        assert torch.equal(_bits(x), _bits(y)), name


def test_trip_body_looped_by_hand_reproduces_sync_loop(monkeypatch):
    """At the bench's operating point (W=30, F=60, N=130), capped at 8
    trips to keep the CPU's time: some windows finish inside the cap and
    freeze while the others run on."""
    monkeypatch.setattr(tsync, "OUTER_MAX_ITERS", 8)
    prob, table, wins = _problem("cpu")
    d0, M0, var_k, centers, radius = _loop_inputs(prob, table, wins, spread_s=0.0005)
    assert wins.rays_a.shape == (30, 3, 60, 130)
    res = tsync.sync_loop(table, wins, d0, M0, var_k, centers, radius)

    ts = tsync._trial_steps(d0.dtype, d0.device)
    st = tsync._loop_start(d0, M0)
    with torch.no_grad():
        for _ in range(8):
            if bool(st.done.all()):
                break
            st = tsync._sync_trip(table, wins, var_k, centers, radius, ts, st, "irls")
        cost = tsync.window_loss(table, wins, st.delay, st.M, var_k)
    assert_bit_equal(res, SyncResult(cost, st.delay, st.iters, st.tr_d, st.tr_s,
                                     st.motion_iters))
    assert 0 < int((res.iterations < 8).sum()) < 30 and int(res.iterations.max()) == 8


# ---------------------------------------------------------------------------
# the card: the graph against the eager loop


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the graph has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def operating_point(cuda):
    return _problem(cuda)


def _eager(monkeypatch, fn, *args, **kw):
    """fn with every sync_loop eager (on the card too)."""
    with monkeypatch.context() as m:
        m.setattr(tsync, "_use_graph", lambda delay0, motion_opt: False)
        return fn(*args, **kw)


def _graphed(fn, *args, **kw):
    """fn recorded: its result, its trips and its graph counts."""
    with recording() as rec:
        out = fn(*args, **kw)
        torch.cuda.synchronize()
    return out, rec.counted("outer_iters"), [rec.counted(c) for c in GRAPH_COUNTS]


def _compare_loop(monkeypatch, table, wins, *args, fresh=True):
    if fresh:
        tsync._GRAPHS.clear()
    got, trips, (captures, replays) = _graphed(tsync.sync_loop, table, wins, *args)
    assert captures == int(fresh) and replays == trips > 0
    assert_bit_equal(got, _eager(monkeypatch, tsync.sync_loop, table, wins, *args))
    return got


@pytest.mark.cuda
def test_graph_matches_eager_at_the_operating_point(cuda, operating_point, monkeypatch):
    prob, table, wins = operating_point
    assert wins.rays_a.shape == (30, 3, 60, 130)
    res = _compare_loop(monkeypatch, table, wins, *_loop_inputs(prob, table, wins))
    assert float((res.delay - prob.true_delay).abs().max()) < 5e-4


@pytest.mark.cuda
def test_graph_matches_eager_over_15_windows(cuda, operating_point, monkeypatch):
    prob, table, wins = operating_point
    wins15 = wins.map(lambda x: x[:15].contiguous())
    _compare_loop(monkeypatch, table, wins15, *_loop_inputs(prob, table, wins15, seed=3))


@pytest.mark.cuda
def test_graph_matches_eager_in_sync_window(cuda, operating_point, monkeypatch):
    prob, table, wins = operating_point
    win = wins.map(lambda x: x[4])
    tsync._GRAPHS.clear()

    def one():
        return tsync.sync_window(table, win, prob.true_delay + 0.003, 0.0, 0.2,
                                 torch.Generator(cuda).manual_seed(11))

    got, trips, (captures, replays) = _graphed(one)
    assert got.delay.shape == () and captures == 1 and replays == trips > 0
    assert_bit_equal(got, _eager(monkeypatch, one))


@pytest.mark.cuda
def test_graph_matches_eager_with_a_stacked_table(cuda, monkeypatch):
    """Two clips (different gyro logs and delays) as one batch, each
    window read from its clip's table: the multi-clip Sync."""
    parts = [_problem(cuda, duration=10.0, seed=s, true_delay=d)
             for s, d in ((1, 0.0311), (2, -0.0152))]
    wins = B.stack_windows([w for _, _, ws in parts
                            for w in [ws.map(lambda x, i=i: x[i]) for i in range(5)]])
    table = stack_tables([t for _, t, ws in parts for _ in range(ws.counts.shape[0])])
    assert table.coeffs.dim() == 3 and table.coeffs.shape[0] == wins.counts.shape[0] == 10
    W, dev = 10, cuda
    truth = torch.tensor([p.true_delay for p, _, _ in parts], device=dev).repeat_interleave(5)
    d0 = truth + torch.linspace(-0.003, 0.003, W, device=dev)
    M0, var_k = tsync.init_motion_batched(table, wins, d0, torch.Generator(dev).manual_seed(5))
    res = _compare_loop(monkeypatch, table, wins, d0, M0, var_k, torch.zeros(W, device=dev),
                        torch.full((W,), 0.2, device=dev))
    assert float((res.delay - truth).abs().max()) < 5e-4


@pytest.mark.cuda
def test_graph_matches_eager_when_windows_leave_their_radius(cuda, operating_point,
                                                             monkeypatch):
    """Every other window searches 0.5 ms about its start, up to 4 ms off
    the truth, so it steps out of its radius and stops there."""
    prob, table, wins = operating_point
    d0, M0, var_k, centers, radius = _loop_inputs(prob, table, wins, seed=4)
    odd = torch.arange(d0.shape[0], device=cuda) % 2 == 1
    centers = torch.where(odd, d0, centers)
    radius = torch.where(odd, 0.0005, radius)
    res = _compare_loop(monkeypatch, table, wins, d0, M0, var_k, centers, radius)
    out = (res.delay - centers).abs() > radius
    assert int(out.sum()) >= 10 and not bool(out[~odd].any())


@pytest.mark.cuda
def test_second_call_reuses_the_graph(cuda, operating_point, monkeypatch):
    prob, table, wins = operating_point
    first = _loop_inputs(prob, table, wins, seed=6)
    second = _loop_inputs(prob, table, wins, spread_s=0.002, seed=7)
    a = _compare_loop(monkeypatch, table, wins, *first)
    b = _compare_loop(monkeypatch, table, wins, *second, fresh=False)
    assert not torch.equal(a.delay, b.delay)
    (entry,) = tsync._GRAPHS[cuda][1].values()
    assert entry.graph is not None


@pytest.mark.cuda
def test_lbfgs_motion_stays_eager(cuda, operating_point, monkeypatch):
    prob, table, wins = operating_point
    wins15 = wins.map(lambda x: x[:15].contiguous())
    args = _loop_inputs(prob, table, wins15, seed=8)
    tsync._GRAPHS.clear()
    got, trips, counts = _graphed(tsync.sync_loop, table, wins15, *args, "lbfgs")
    assert counts == [0, 0] and trips > 0 and not tsync._GRAPHS
    assert_bit_equal(got, _eager(monkeypatch, tsync.sync_loop, table, wins15, *args, "lbfgs"))
    assert float((got.delay - prob.true_delay).abs().max()) < 5e-4


@pytest.mark.cuda
def test_threads_on_one_card_share_the_graph_safely(cuda, operating_point, monkeypatch):
    """Four threads (more than the graphs' one lock lets in at a time) run
    the loop on one card at once, with inputs of their own: each gets its
    eager result."""
    import sys
    import threading

    prob, table, wins = operating_point
    wins15 = wins.map(lambda x: x[:15].contiguous())
    args = [_loop_inputs(prob, table, wins15, spread_s=0.001 * (k + 1), seed=20 + k)
            for k in range(4)]
    want = [_eager(monkeypatch, tsync.sync_loop, table, wins15, *a) for a in args]
    tsync._GRAPHS.clear()
    got = [None] * 4

    def run(k):
        got[k] = tsync.sync_loop(table, wins15, *args[k])
        torch.cuda.current_stream().synchronize()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        assert_bit_equal(g, w)
    assert len(tsync._GRAPHS[cuda][1]) == 1
