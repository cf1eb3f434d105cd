"""The 30 fps configuration and its cell `hero6-30.clip`, on the CPU:
the configuration is the 60 fps one at 30 fps; the cell, with its
configuration scaled down as conftest.TINY scales the 60 fps one, runs
through `harness.run` and is correct against the plain reference; its
request loop records the program's spans in traced runs only, and its
two readers read them, or nothing from a program without them."""

import importlib.util
import json
import shutil
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.reference import truth
from rssync_tpu_torch.utils.timing import count, recording, recording_on, span

ROOT = Path(__file__).resolve().parents[2]
CELL = "hero6-30.clip"
SEED = 2**31 + 305


def _tiny():
    spec = importlib.util.spec_from_file_location("portbench_conftest",
                                                  Path(__file__).with_name("conftest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.TINY


@pytest.fixture(scope="module")
def clip30_root(tmp_path_factory) -> Path:
    """A copy of the checkout's benchmark whose 30 fps configuration is
    scaled down as conftest.TINY scales the 60 fps one, and the cell's
    track limits as make_tiny_root scales them (a frame an eighth as
    wide)."""
    dst = tmp_path_factory.mktemp("clip30")
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    path = dst / "portbench/configs/hero6_2704x2028_30fps.json"
    cfg = json.loads(path.read_text())
    for k, v in _tiny().items():
        if isinstance(v, dict):
            cfg[k].update(v)
        else:
            cfg[k] = v
    path.write_text(json.dumps(cfg))
    lim_path = dst / f"portbench/limits/{CELL}.json"
    limits = json.loads(lim_path.read_text())
    limits["limits"].update(track_err_px_p50=0.6, track_err_px_p90=2.0)
    lim_path.write_text(json.dumps(limits))
    return dst


def test_config_is_the_60fps_one_at_30fps():
    bench = harness.load_benchmark(ROOT)
    files = {c["name"]: json.loads((ROOT / c["file"]).read_text()) for c in bench["configs"]}
    c30, c60 = files["hero6_2704x2028_30fps"], files["hero6_2704x2028_60fps"]
    differ = {k for k in c60 if c30[k] != c60[k]}
    assert differ == {"name", "source", "deployment", "camera"}
    assert {k for k in c60["camera"] if c30["camera"][k] != c60["camera"][k]} == {"fps"}
    assert c30["camera"]["fps"] == 30.0 and c30["reduced"] == []
    clip = harness.make_clip(c30, SEED, "cpu", render=False)
    assert len(clip.syncpoints) == 15 and len(clip.frame_index) == 930
    cell = harness.find_cell(CELL, ROOT)
    assert cell.limits == harness.find_cell("hero6-60.clip", ROOT).limits
    mix60 = json.loads((ROOT / "portbench/mixes/clip.json").read_text())
    assert {k: v for k, v in cell.mix.items() if k not in ("about", "request")} == \
        {k: v for k, v in mix60.items() if k not in ("about", "request")}


class _SyncSpans(harness.Spans):
    """Spans of a traced run (`sync` set, as on a card) whose end skips
    the device synchronize the CPU has not got."""

    def __init__(self, sync: bool = False):
        super().__init__(sync=True)

    @contextmanager
    def __call__(self, name, request):
        self.sync = False
        try:
            with super().__call__(name, request):
                yield
        finally:
            self.sync = True


def test_cell_runs_correct_and_records_only_when_traced(clip30_root, monkeypatch):
    cell = harness.find_cell(CELL, clip30_root)
    assert cell.request.__file__.endswith("requests/batched_recorded.py")
    readers = {m["name"] for m, _ in cell.per_layer}
    assert {"track_coarse_ms_per_pair.clip30", "lk_edge_pct.clip30",
            "track_ms_per_pair.clip"} <= readers
    out = harness.run(CELL, SEED, 1.0, False, "cpu", clip30_root)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"clip_s", "setup_s"}

    monkeypatch.setattr(harness, "Spans", _SyncSpans)
    traced = harness.run(CELL, SEED + 1, 1.0, True, "cpu", clip30_root)
    assert traced["correct"] is True, traced["checks"]
    m = traced["metrics"]
    assert {"track_coarse_ms_per_pair.clip30", "lk_edge_pct.clip30", "track_ms_per_pair.clip",
            "presync_ms.clip", "sync4x_ms.clip"} <= set(m)
    assert m["track_coarse_ms_per_pair.clip30"]["value"] > 0
    assert 0.0 <= m["lk_edge_pct.clip30"]["value"] <= 100.0


def _ctx(recs, cfg):
    reqs = [SimpleNamespace(recorder=r) for r in recs]
    return SimpleNamespace(window_requests=lambda: reqs,
                           cell=SimpleNamespace(config=cfg))


def test_readers_read_the_recorders_or_nothing():
    cfg = json.loads((ROOT / "portbench/configs/hero6_2704x2028_30fps.json").read_text())
    coarse = harness._reader(ROOT, "track_coarse_ms_per_pair.clip30")
    edge = harness._reader(ROOT, "lk_edge_pct.clip30")
    n = len(truth.grid_points(2704, 2028, 200))
    recs = []
    for k in range(2):
        with recording(context=k) as rec:
            with span("track.block"):
                count("pairs", 16)
                with span("track.coarse"):
                    pass
                count("lk_edge_points", 13 * k)
        recs.append(rec)
    want_ms = sum((s.end_ns - s.start_ns) * 1e-6 for r in recs for s in r.records
                  if s.name == "track.coarse") / 32
    assert coarse.read(_ctx(recs, cfg)) == pytest.approx(want_ms)
    assert edge.read(_ctx(recs, cfg)) == pytest.approx(100.0 * 13 / (32 * n))
    # a program with the spans and no edge count (the parent of the
    # count), and requests without recorders (an untraced run)
    with recording() as old:
        with span("track.block"):
            count("pairs", 16)
            with span("track.coarse"):
                pass
    assert edge.read(_ctx([old], cfg)) is None and coarse.read(_ctx([old], cfg)) > 0
    assert edge.read(_ctx([], cfg)) is None and coarse.read(_ctx([], cfg)) is None


def test_bf16_control_fails_a_limit_of_the_cell(clip30_root):
    from portbench import control

    cell = harness.find_cell(CELL, clip30_root)
    clip = harness.make_clip(cell.config, SEED, "cpu", render=False)
    ok, checks = harness.judge(harness.compare(cell, clip, control.control_requests(cell, clip)),
                               cell.limits)
    assert not ok
    assert any(c["value"] > c["limit"] for c in checks.values())


def test_untraced_request_records_nothing(clip30_root, monkeypatch):
    """batched_recorded runs batched.py's `run` as it is: outside any
    recording untraced, inside one (kept on the request) traced."""
    cell = harness.find_cell(CELL, clip30_root)
    calls = []
    monkeypatch.setattr(cell.request._BATCHED, "run",
                        lambda d, r, s: calls.append(recording_on()) or "problem")
    untraced, traced = harness.Request(index=0, windows=[0]), harness.Request(index=1, windows=[0])
    assert cell.request.run(None, untraced, harness.Spans(sync=False)) == "problem"
    assert cell.request.run(None, traced, _SyncSpans()) == "problem"
    assert calls == [False, True]
    assert not hasattr(untraced, "recorder") and traced.recorder.context == 1
