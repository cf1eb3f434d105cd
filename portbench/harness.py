"""One run of one cell: set-up, a measured window of requests from one
closed-loop client, the comparison with the plain reference, and the
result line.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell lives in a file of its own that this module finds by the
name in BENCHMARK.json: `configs/<config>.json` (the `file` of the
configuration), `mixes/<traffic>.json` (the mix's parameters, which
name the request loop `requests/<request>.py`), `metrics/<metric>.py`
(or, for a metric `<name>.<cell suffix>` with no file of its own,
`metrics/<name>.py`) and `limits/<cell>.json`.

The program under test is `rssync_tpu_torch`, driven through its
public entry points: `create_sync_problem`, `pipeline.recipe`'s
`set_gyro_rates`, `window_pair_ranges`, `syncpoint_windows`,
`presync_stage` and `sync_stage` (the stages `run_batched` chains),
`frontend.tracking.track_clip`, and `SyncProblem.pre_sync` / `sync`
(the calls `run_sequential` makes), from the request loops under
`requests/`. The frames and the gyro log come
from `portbench.gen`, the answers are judged by `portbench.reference`.

A configuration names its scene by the key `model` of its `scene`
section, and the scene's files are found like the cell's others, under
the cell's checkout: the clip's renderer and gyro log are
`gen/<model>.py`'s `bind(scene)` (an object with the functions of
`gen/synthclip.py`), its truth is `reference/<model>.py` (the functions
of `reference/truth.py`). Without the key the scene is the frozen pair
`gen/synthclip.py` and `reference/truth.py`, called as they always
were. `make_clip` takes the renderer from `scene_renderer`; `compare`
and `control.control_requests` take the truth from `scene_truth`.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import re
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

#: the checkout's root (the parent of portbench/)
ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that may not be loaded when the window closes
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "rssync_tpu")


# ---------------------------------------------------------------------------
# finding a cell's files by name


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


@dataclass
class Cell:
    """A cell of BENCHMARK.json with the files it names."""

    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict
    mix: dict
    #: the mix's request loop: a module with `run(driver, request, spans)`
    request: object
    limits: dict
    #: (metric entry, reader module) of the end-to-end metrics other than
    #: setup_s, and of the per-layer metrics, that this cell reports
    end_to_end: list
    per_layer: list
    #: the checkout the cell's files were found in
    root: Path = ROOT


def _module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {tag.split('_')[1]} file at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reader(root: Path, name: str):
    """The reader of metric `name`: `metrics/<name>.py`, or for a name
    with a cell suffix (`device_idle_pct.clip`) and no file of its own,
    the shared `metrics/<name without the suffix>.py`."""
    d = root / "portbench" / "metrics"
    path = d / f"{name}.py"
    if not path.exists() and "." in name:
        path = d / f"{name.rsplit('.', 1)[0]}.py"
    return _module(path, f"portbench_metric_{name}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "mixes" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    request = _module(root / "portbench" / "requests" / f"{mix['request']}.py",
                      f"portbench_request_{mix['request']}")
    with open(root / "portbench" / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    e2e = [(m, _reader(root, m["name"])) for m in bench["end_to_end"]
           if m["name"] != "setup_s" and _applies(m, name)]
    layer = [(m, _reader(root, m["name"])) for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), config, mix, request, limits,
                e2e, layer, root)


# ---------------------------------------------------------------------------
# the scene a configuration names


#: the scene modules loaded in this process, by file
_SCENE_MODULES: dict = {}


def _scene_module(config: dict, root: Path, kind: str, default: str):
    """`portbench/<kind>/<model>.py` of the configuration's `scene.model`
    under `root`, or `<default>.py` without the key: loaded once a
    process, and kept in `sys.modules` (a dataclass of the module, such
    as synthclip's `LensParams`, looks its module up there)."""
    model = config["scene"].get("model")
    if model is not None and not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", model):
        raise ValueError(f"scene.model must be a module name, not {model!r}")
    path = (root / "portbench" / kind / f"{model or default}.py").resolve()
    if path not in _SCENE_MODULES:
        if not path.exists():
            raise FileNotFoundError(f"no {kind} file at {path}")
        tag = f"portbench_{kind}_{path.stem}_{len(_SCENE_MODULES)}"
        spec = importlib.util.spec_from_file_location(tag, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[tag] = mod
        spec.loader.exec_module(mod)
        _SCENE_MODULES[path] = mod
    return _SCENE_MODULES[path]


def scene_renderer(config: dict, root: Path = ROOT):
    """The renderer and gyro log of the configuration's scene
    (`hero6_lens`, `trajectory_params`, `gyro_log`, `render_frames`, as
    `gen/synthclip.py` has them): `gen/<model>.py`'s
    `bind(config["scene"])`, or `gen/synthclip.py` itself without
    `scene.model`."""
    mod = _scene_module(config, root, "gen", "synthclip")
    return mod if config["scene"].get("model") is None else mod.bind(config["scene"])


def scene_truth(config: dict, root: Path = ROOT):
    """The truth of the configuration's scene (`grid_points`,
    `true_tracks`, `undistort_ray`, `tracked_pixels`, `window_delays`,
    as `reference/truth.py` has them): `reference/<model>.py`, or
    `reference/truth.py` without `scene.model`."""
    return _scene_module(config, root, "reference", "truth")


# ---------------------------------------------------------------------------
# the clip a run syncs


@dataclass
class Clip:
    """The frames the cell's windows read, rendered from the seed, and
    the clip's gyro log. Frames are stored back to back, window after
    window: frame k of the store is clip frame `frame_index[k]`, so
    window w starts at store frame `starts[w]` and the program, which
    keys tracks by frame number only, sees each window exactly as in the
    whole clip."""

    fps: float
    width: int
    height: int
    #: the scene's `hero6_lens` of the camera
    lens: object
    #: the scene's draw from the seed, as its truth takes it
    trajectory: object
    gyro_ts: np.ndarray
    gyro_rates: np.ndarray
    #: the delay at video time 0 (true_delay + pad / 2), its drift (s/s)
    #: and the engine's search centre (pad / 2), s
    engine_delay: float
    drift: float
    initial_delay: float
    #: first clip frame of each window
    syncpoints: np.ndarray
    #: first store frame of each window
    starts: np.ndarray
    frame_index: np.ndarray
    frames: torch.Tensor | None
    frame_ts: np.ndarray


def make_syncpoints(n_frames: int, window: int, distance: int) -> list[int]:
    """The recipe's "auto" schedule (ref: core_testcode.cpp:270-280)."""
    out, pos = [], 0
    while pos + window < n_frames:
        out.append(pos)
        pos += distance
    return out


def true_delay(config: dict, seed: int) -> float:
    lo, hi = config["scene"]["true_delay_s"]
    return float(np.random.default_rng([seed, 1]).uniform(lo, hi))


def make_clip(config: dict, seed: int, device, render: bool = True,
              root: Path = ROOT) -> Clip:
    cam, rec = config["camera"], config["recipe"]
    fps, W, H = float(cam["fps"]), int(cam["width"]), int(cam["height"])
    n_frames = int(round(config["clip_s"] * fps))
    window = int(rec["sync_window"])
    sps = np.asarray(make_syncpoints(n_frames, window, int(rec["syncpoint_distance"])))
    # pairs p .. p + window of each window: frames p .. p + window + 1
    per = window + 2
    frame_index = (sps[:, None] + np.arange(per)[None]).reshape(-1)
    gen = scene_renderer(config, root)
    lens = gen.hero6_lens(W, H, float(cam["readout_s"]))
    pad = float(config["gyro_pad_s"])
    # the run's seed draws the scene (motion and texture), the delay, the
    # problems' RANSAC seeds and the order of the sync points
    scene = seed
    delay = true_delay(config, seed)
    drift = float(config["scene"]["drift_s_per_s"])
    gyro_ts, gyro_rates = gen.gyro_log(scene, n_frames / fps, delay, pad,
                                       float(cam["gyro_rate_hz"]), drift)
    frames = None
    if render:
        frames = gen.render_frames(scene, frame_index.tolist(), fps, W, H,
                                   float(cam["readout_s"]), device, lens)
    return Clip(fps=fps, width=W, height=H, lens=lens,
                trajectory=gen.trajectory_params(scene), gyro_ts=gyro_ts,
                gyro_rates=gyro_rates, engine_delay=delay + pad / 2, drift=drift,
                initial_delay=pad / 2,
                syncpoints=sps, starts=np.arange(len(sps)) * per, frame_index=frame_index,
                frames=frames, frame_ts=frame_index / fps)


# ---------------------------------------------------------------------------
# spans


@dataclass
class Span:
    name: str
    request: int
    #: time.perf_counter() seconds
    start: float
    end: float
    #: the same instants on the wall clock (time.time_ns()), the clock of
    #: the profiler's trace
    wall_start: int
    wall_end: int


class Spans:
    """Harness spans around the calls into each layer, kept in memory.
    With `sync`, each span ends on a device synchronize, so its length
    holds its device work."""

    def __init__(self, sync: bool = False):
        self.sync = sync
        self.records: list[Span] = []

    @contextmanager
    def __call__(self, name: str, request: int):
        w0, t0 = time.time_ns(), time.perf_counter()
        yield
        if self.sync:
            torch.cuda.synchronize()
        self.records.append(Span(name, request, t0, time.perf_counter(), w0, time.time_ns()))


# ---------------------------------------------------------------------------
# requests


@dataclass
class Request:
    index: int
    windows: list
    start: float = 0.0
    end: float = 0.0
    failed: str | None = None
    #: PreSync's and the final delay of each window, s (host after the
    #: window; PreSync's may be a device tensor until then)
    presync: object = None
    final: list = field(default_factory=list)
    problem: object = None
    #: per window: (frames present, features of each, (3, F, N) rays_b)
    tracks: list = field(default_factory=list)
    #: run under the profiler after the window (traced runs)
    profiled: bool = False


class Driver:
    """Runs the requests of one mix on one clip through the program: the
    mix's request loop (`requests/<request>.py`) calls `new_problem` and
    `track` and then the engine's stages, and returns the problem."""

    def __init__(self, cell: Cell, clip: Clip, seed: int, device):
        from rssync_tpu_torch.frontend import tracking
        from rssync_tpu_torch.ops.lens import Lens
        from rssync_tpu_torch.pipeline import recipe

        import rssync_tpu_torch

        self.api, self.tracking, self.recipe = rssync_tpu_torch, tracking, recipe
        self.cell, self.clip, self.seed, self.device = cell, clip, seed, torch.device(device)
        self.lens = Lens(**vars(clip.lens))
        rec = cell.config["recipe"]
        self.window = int(rec["sync_window"])
        self.initial_delay = clip.initial_delay
        self.radius_ms = float(rec["presync_radius_ms"])
        self.step_ms = float(rec["presync_step_ms"])
        self.passes = int(rec["sync_passes"])
        self.motion_opt = rec["motion_opt"]
        self.grid_step = int(cell.config["tracker"]["grid_step"])
        self.orient = cell.config["camera"]["gyro_orientation"]
        self.per_request = cell.mix["windows_per_request"]
        self._order = np.random.default_rng([seed, 2])
        self._queue: list[int] = []

    def next_windows(self) -> list[int]:
        n = len(self.clip.syncpoints)
        if self.per_request == "all":
            return list(range(n))
        out = []
        for _ in range(int(self.per_request)):
            if not self._queue:
                self._queue = self._order.permutation(n).tolist()
            out.append(self._queue.pop(0))
        return out

    def request_seed(self, index: int) -> int:
        return int(np.random.default_rng([self.seed, 3, index + 10]).integers(0, 2**62))

    def new_problem(self, req: Request, spans: Spans):
        """A fresh problem with the clip's gyro log set."""
        with spans("problem", req.index):
            sp = self.api.create_sync_problem(seed=self.request_seed(req.index),
                                              device=self.device)
            self.recipe.set_gyro_rates(sp, self.clip.gyro_ts, self.clip.gyro_rates, self.orient)
        return sp

    def track(self, sp, req: Request, spans: Spans) -> list[int]:
        """The request's windows' pairs tracked into `sp`; returns the
        windows' first frames."""
        starts = [int(self.clip.starts[w]) for w in req.windows]
        with spans("track", req.index):
            self.tracking.track_clip(sp, self.lens, self.clip.frames, self.clip.frame_ts,
                                     self.recipe.window_pair_ranges(starts, self.window),
                                     grid_step=self.grid_step)
        return starts

    def run(self, req: Request, spans: Spans) -> None:
        """One request, by the mix's request loop; it ends on a host read
        of the delays. The problem stays on the request for `read_back`."""
        req.problem = self.cell.request.run(self, req, spans)

    def read_back(self, req: Request) -> None:
        """Copy what the request produced to the host and drop the
        problem: PreSync's delays, and the tracks the engine read (each
        window's closed track window, as the engine built it)."""
        if isinstance(req.presync, torch.Tensor):
            req.presync = req.presync.double().cpu().tolist()
        sp, req.problem = req.problem, None
        if sp is None:
            req.tracks = None
            return
        for w in req.windows:
            s = int(self.clip.starts[w])
            try:
                win = sp.build_window(s, s + self.window, closed=True)
            except RuntimeError:  # no track data in the window at all
                req.tracks.append((0, np.zeros(0, np.int64), None))
                continue
            req.tracks.append((int(win.frame_mask.sum()), win.counts.cpu().numpy(),
                               win.rays_b.double().cpu()))


# ---------------------------------------------------------------------------
# the comparison that decides `correct`


def compare(cell: Cell, clip: Clip, requests: list[Request], dtype=torch.float64) -> dict:
    """Each number compared, from the requests' answers against the
    plain reference (the scene's truth, computed in `dtype`): failed
    requests; missing tracks (pairs or features the engine did not get)
    and the median and the 90th percentile of the tracked points'
    errors, px, over points whose true position stays `edge_px` inside
    the frame, of the requests whose tracks were kept; the worst PreSync
    and the worst final delay, ms, of every request."""
    cfg = cell.config
    ref = scene_truth(cfg, cell.root)
    W, H, step = clip.width, clip.height, int(cfg["tracker"]["grid_step"])
    window = int(cfg["recipe"]["sync_window"])
    edge = float(cell.limits["edge_px"])
    grid = ref.grid_points(W, H, step)
    lens = vars(clip.lens)
    n_pairs = window + 1
    frames_a = (clip.syncpoints[:, None] + np.arange(n_pairs)[None]).reshape(-1)
    want = ref.true_tracks(clip.trajectory, lens, grid, frames_a, clip.fps, H, dtype)
    want = want.to(torch.float64).reshape(len(clip.syncpoints), n_pairs, len(grid), 2)
    inside = ((want[..., 0] >= edge) & (want[..., 0] <= W - 1 - edge)
              & (want[..., 1] >= edge) & (want[..., 1] <= H - 1 - edge))
    want_delay = ref.window_delays(clip.syncpoints, clip.fps, window, clip.engine_delay,
                                   clip.drift, dtype)
    want_delay = want_delay.to(torch.float64)

    missing, errs, pre_err, fin_err = 0, [], 0.0, 0.0
    for req in requests:
        if req.failed:
            continue
        for k, w in enumerate(req.windows):
            if req.tracks is not None:
                present, counts, rays_b = req.tracks[k]
                missing += n_pairs - present + int(np.sum(np.maximum(len(grid) - counts, 0)))
                if present == n_pairs and rays_b is not None and rays_b.shape[-1] == len(grid):
                    got = ref.tracked_pixels(lens, rays_b.permute(1, 2, 0))  # (F, N, 2)
                    errs.append(torch.linalg.vector_norm(got - want[w], dim=-1)[inside[w]])
            pre_err = max(pre_err, abs(float(req.presync[k]) - float(want_delay[w])) * 1e3)
            fin_err = max(fin_err, abs(float(req.final[k]) - float(want_delay[w])) * 1e3)
    e = torch.cat(errs) if errs else torch.full((1,), math.inf, dtype=torch.float64)
    e = torch.sort(torch.nan_to_num(e, nan=math.inf)).values

    def q(p):  # the p-th quantile, nearest rank
        return float(e[min(len(e) - 1, int(p * len(e)))])

    _log(f"# tracked points compared: {len(e)}; error p99 {q(0.99):.4f} px, max "
         f"{float(e[-1]):.4f} px, a share {float((e > 1.0).double().mean()):.6f} over 1 px")
    return {
        "requests_failed": sum(1 for r in requests if r.failed),
        "tracks_missing": missing,
        "track_err_px_p50": q(0.5),
        "track_err_px_p90": q(0.9),
        "presync_err_ms_max": pre_err,
        "sync_err_ms_max": fin_err,
    }


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every number against its limit (not above it); (correct, checks)."""
    checks = {k: {"value": v, "limit": limits["limits"][k]} for k, v in numbers.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


# ---------------------------------------------------------------------------
# the run


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is one that
    may not be loaded."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


@dataclass
class Context:
    """What a metric's reader reads."""

    cell: Cell
    clip: Clip
    #: seconds the client spent inside the window's requests
    window_s: float
    requests: list
    spans: list
    trace: object = None

    def window_requests(self) -> list:
        return [r for r in self.requests if not r.failed and not r.profiled]


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
        root: Path = ROOT, t_process: float | None = None) -> dict:
    """One run of `workload`; returns the result line's object."""
    t_setup = t_process if t_process is not None else time.perf_counter()
    cell = find_cell(workload, root)
    on_card = _cuda(device)
    import rssync_tpu_torch  # noqa: F401  (pins float32 matmuls to IEEE)

    clip = make_clip(cell.config, seed, device, root=cell.root)
    driver = Driver(cell, clip, seed, device)
    spans = Spans(sync=trace and on_card)
    for k in range(int(cell.mix["warmup_requests"])):
        warm = Request(index=-1 - k, windows=driver.next_windows())
        driver.run(warm, Spans())
        warm.problem = None
    driver._queue, driver._order = [], np.random.default_rng([seed, 2])
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup
    _log(f"# {workload} seed {seed}: set-up {setup_s:.3f} s, {len(clip.frame_index)} frames "
         f"of {clip.width}x{clip.height} rendered, {len(clip.syncpoints)} windows")

    # the measured window: one client, each request as the last ended.
    # Between requests, outside the window's clock, the harness copies
    # each request's answers to the host and drops its problem, so every
    # request runs alone and every one is compared
    requests: list[Request] = []
    window_s = 0.0
    while window_s < seconds:
        req = Request(index=len(requests), windows=driver.next_windows())
        req.start = time.perf_counter()
        try:
            driver.run(req, spans)
        except Exception as exc:  # a failed request counts, the window goes on
            req.failed = f"{type(exc).__name__}: {exc}"
            _log(f"# request {req.index} failed: {req.failed}")
        req.end = time.perf_counter()
        window_s += req.end - req.start
        requests.append(req)
        if not req.failed:
            driver.read_back(req)
    by_req: dict = {}
    for sp in spans.records:
        by_req.setdefault(sp.request, {}).setdefault(sp.name, 0.0)
        by_req[sp.request][sp.name] += sp.end - sp.start
    for r in requests:
        parts = " ".join(f"{k} {v:.3f}" for k, v in by_req.get(r.index, {}).items())
        _log(f"# request {r.index}: {r.end - r.start:.3f} s ({parts})")

    tr = None
    if trace:
        from portbench import tracing

        tr = tracing.profile_requests(driver, requests, int(cell.mix["profiled_requests"]),
                                      on_card)
    bad = forbidden_loaded()
    if bad:
        raise SystemExit(f"portbench: forbidden modules loaded: {bad}")
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    # the profiled requests' outputs to the host, the program's state
    # freed, then the reference
    for req in (tr.requests if tr else []):
        driver.read_back(req)
    ctx = Context(cell, clip, window_s, requests, spans.records, tr)
    metric_list = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m, reader in metric_list:
        value = reader.read(ctx)
        if value is None:
            _log(f"# metric {m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if not trace:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    clip.frames = None
    del driver
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = compare(cell, clip, requests)
    correct, checks = judge(numbers, cell.limits)
    _log(f"# window: {len(requests) - len(tr.requests if tr else [])} requests in "
         f"{window_s:.3f} s; reference and comparison "
         f"{time.perf_counter() - t_ref:.1f} s")
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips if on_card else 0, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(requests),
           "failed": sum(1 for r in requests if r.failed), "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        out["breakdown"] = tr.breakdown()
    out["checks"] = checks
    return out
