"""The harness finds what belongs to a cell by name, prints the result
line the contract asks for, needs a card, and loads nothing of JAX."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_every_cell_of_the_benchmark_is_found_by_name():
    bench = harness.load_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"], ROOT)
        assert cell.config["name"] == w["config"]
        assert set(cell.limits["limits"]) >= {"sync_err_ms_max", "track_err_px_p50"}
        names = [m["name"] for m, _ in cell.end_to_end + cell.per_layer]
        assert names and all(callable(r.read) for _, r in cell.end_to_end + cell.per_layer)


def test_benchmark_json_keeps_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert list(bench) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    assert 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert name.match(c["name"]) and c["reduced"] == []
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == []
    for m in bench["end_to_end"]:
        assert name.match(m["name"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert name.match(m["name"]) and m["moves"] in e2e
        assert harness._reader(ROOT, m["name"]).read
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in bench["workloads"]:
        assert name.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
        mix = json.loads((PKG / "mixes" / f"{w['traffic']}.json").read_text())
        assert (PKG / "requests" / f"{mix['request']}.py").exists()
        reported = [m for m in bench["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in bench["per_layer"])


def test_a_cell_added_as_files_runs(tiny_root):
    """tiny.point: a configuration, a mix with its own request loop, an
    end-to-end and a per-layer metric and limits added as new files and
    BENCHMARK.json entries, run on the CPU past the look for a card; the
    result line has the contract's keys, then `checks`."""
    cell = harness.find_cell("tiny.point", tiny_root)
    assert cell.request.__file__.endswith("requests/tiny_sequential.py")
    readers = {m["name"]: r.__file__ for m, r in cell.per_layer}
    assert readers["problem_ms.tiny"].endswith("metrics/problem_ms.tiny.py")
    assert readers["track_ms_per_pair.point"].endswith("metrics/track_ms_per_pair.py")
    out = harness.run("tiny.point", 2**31 + 77, 2.0, False, "cpu", tiny_root)
    assert list(out) == KEYS + ["checks"]
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"point_p90_s", "setup_s"}
    assert out["attempted"] >= 1 and out["failed"] == 0
    traced = harness.run("tiny.point", 2**31 + 78, 1.0, True, "cpu", tiny_root)
    assert list(traced) == KEYS + ["breakdown", "checks"]
    assert set(traced["metrics"]) == {"track_ms_per_pair.point", "problem_ms.tiny"}
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(traced["device"])


def _run(cwd, *args):
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "hero6-60.clip", "--seed", "5", "--seconds", "1", "--trace", "0",
                           *args], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = _run(ROOT)
    assert r.returncode != 0 and r.stdout == ""
    assert "needs 1 CUDA card" in r.stderr


def test_run_fails_with_only_the_benchmark_files(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    import shutil

    shutil.copytree(PKG, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout == ""


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = [p for p in PKG.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        bad = _top_level_imports(p) & {"jax", "jaxlib", "flax", "rssync_tpu"}
        assert not bad, (p, bad)
    for sub in ("reference", "gen", "metrics"):
        for p in (PKG / sub).rglob("*.py"):
            assert "rssync_tpu_torch" not in _top_level_imports(p), p


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("rssync_tpu_torch.core", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    for name in ("jax", "jax.numpy", "rssync_tpu", "jaxlib", "flax"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "rssync_tpu.ops", sys)
    assert harness.forbidden_loaded() == ["rssync_tpu"]


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = _run(ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"] is True
