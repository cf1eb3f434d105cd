"""Fixtures of the benchmark's CPU tests: a copy of the checkout's
benchmark files with a small cell added as files and entries, as a later
change adds one."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

#: a 4 s clip of 320x240 at 30 fps: 3 windows of 20 frames, 35 points;
#: the drift is ten times the cells' so that windows differ by more than
#: the delay limit
TINY = {"clip_s": 4.0, "camera": {"width": 320, "height": 240, "fps": 30.0},
        "recipe": {"sync_window": 20, "syncpoint_distance": 40},
        "tracker": {"grid_step": 40, "points": 35}, "scene": {"drift_s_per_s": 1e-3}}

DUMMY_METRIC = '''"""A metric a later change adds: milliseconds of the problem span."""

from portbench.metrics import spans


def read(ctx):
    return spans.ms_per_request(ctx, "problem")
'''

#: an end-to-end metric a later change adds with its cell
DUMMY_E2E = '''"""The 90th percentile of the latency of every request of the window."""

from portbench.metrics import arith


def read(ctx):
    lat = [r.end - r.start for r in ctx.requests if not r.profiled]
    return arith.percentile(lat, 90) if lat else None
'''

#: a request loop a later change adds with its mix: one window after
#: another, as `run_sequential` calls the problem
DUMMY_REQUEST = '''"""pre_sync, then the Sync passes as `sync` calls, window by window."""


def run(d, req, spans):
    sp = d.new_problem(req, spans)
    starts = d.track(sp, req, spans)
    radius = d.radius_ms / 1000.0
    req.presync, req.final = [], []
    for pos in starts:
        with spans("presync", req.index):
            _, delay = sp.pre_sync(d.initial_delay, pos, pos + d.window, d.step_ms / 1000.0,
                                   radius)
        req.presync.append(delay)
        with spans("sync4x", req.index):
            for _ in range(d.passes):
                _, delay = sp.sync(delay, pos, pos + d.window, d.initial_delay, radius)
        req.final.append(delay)
    return sp
'''


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


def make_tiny_root(dst: Path) -> Path:
    """A checkout of BENCHMARK.json and portbench/ with two cells added
    as new files and entries, as a later change adds them: tiny.clip, a
    small configuration under the existing mix `clip`; and tiny.point,
    with a new mix `tiny_point` whose request loop `tiny_sequential`,
    end-to-end metric `point_p90_s` and per-layer metric
    `problem_ms.tiny` are new files, and whose per-layer metric
    `track_ms_per_pair.point` reads through the shared
    `metrics/track_ms_per_pair.py`."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    pkg = dst / "portbench"
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / bench["configs"][0]["file"]).read_text())
    cfg["name"] = "tiny"
    for k, v in TINY.items():
        if isinstance(v, dict):
            cfg[k].update(v)
        else:
            cfg[k] = v
    (pkg / "configs/tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append(dict(bench["configs"][0], name="tiny",
                                 file="portbench/configs/tiny.json"))
    (pkg / "mixes/tiny_point.json").write_text(json.dumps(
        {"request": "tiny_sequential", "windows_per_request": 1, "warmup_requests": 2,
         "profiled_requests": 6}))
    (pkg / "requests/tiny_sequential.py").write_text(DUMMY_REQUEST)
    (pkg / "metrics/problem_ms.tiny.py").write_text(DUMMY_METRIC)
    (pkg / "metrics/point_p90_s.py").write_text(DUMMY_E2E)
    # the cell's limits, the tracks' scaled to a frame an eighth as wide
    limits = json.loads((ROOT / "portbench/limits/hero6-60.clip.json").read_text())
    limits["limits"].update(track_err_px_p50=0.6, track_err_px_p90=2.0)
    limits = json.dumps(limits)
    for name, traffic in (("tiny.clip", "clip"), ("tiny.point", "tiny_point")):
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": traffic,
                                   "chips": 1, "why": "a test cell"})
        (pkg / f"limits/{name}.json").write_text(limits)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [w.replace("hero6-60", "tiny") for w in m["workloads"]]
    bench["end_to_end"].append({"name": "point_p90_s", "unit": "s", "better": "lower",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny.point"]})
    for name, layer in (("track_ms_per_pair.point", "frontend.tracking"),
                        ("problem_ms.tiny", "pipeline.recipe")):
        bench["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                                   "source": "host_clock", "layer": layer,
                                   "moves": "point_p90_s", "workloads": ["tiny.point"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("checkout"))
