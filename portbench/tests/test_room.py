"""The scene a configuration names, and the room scene, on the CPU.

(a) Without `scene.model` the harness's scene is the frozen pair
`gen/synthclip.py` and `reference/truth.py`, called as before: frames,
gyro log, trajectory, truth and the control's answers bit-equal to
direct calls. (b) With no translation the room's truth is the pure
rotation's. (c) A grid pixel of frame a and its true pixel in frame
b show one world point. (d) The room meets its floors at 2704x2028 and
60 fps: the camera stays 0.2 m from every wall and every ray leaves the
box, the depth spans 3x a frame, and the translational part of a pair's
motion is large (median 4 px, p90 10 px). (e) Rendered frames agree with
the truth better than with the rotation alone. A tiny room cell runs
through `harness.run`, and its bfloat16 control is not correct.
"""

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import control, harness
from portbench.gen import room as room_gen
from portbench.gen import synthclip
from portbench.reference import room, truth

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 401
#: the `scene` section of a room configuration at its starting values,
#: each assumed (PERF.md §4): the camera 0.3 m above the table and 1.5 m
#: from the wall it faces, pitched 30 degrees down, its centre moving up
#: to 0.08 m an axis at 0.3-1.5 Hz; d_ref the mean depth at the mount
#: pose (0.93 m), so the texture's angular scale there is synthclip's
ROOM = {"model": "room", "box_m": [[-1.0, 1.0], [-1.2, 0.3], [-1.0, 1.5]],
        "mount_pitch_deg": 30.0, "translation_amp_m": [0.08, 0.08, 0.08],
        "translation_hz": [0.3, 1.5], "texture_d_ref_m": 0.93}
W, H, FPS, RO = 2704, 2028, 60.0, 0.01111


def _config(scene=None, **camera) -> dict:
    cfg = json.loads((ROOT / "portbench/configs/hero6_2704x2028_60fps.json").read_text())
    cfg["camera"].update(camera)
    cfg["scene"].update(scene or {})
    return cfg


def _lens(width=W, height=H) -> dict:
    return vars(synthclip.hero6_lens(width, height, RO))


def _small(scene=None) -> dict:
    """The 60 fps configuration at a 96x72 lens, 2 s and 3 windows."""
    cfg = _config(scene, width=96, height=72)
    cfg.update(clip_s=2.0)
    cfg["recipe"].update(sync_window=20, syncpoint_distance=40)
    cfg["tracker"].update(grid_step=16)
    return cfg


# (a) ------------------------------------------------------------------------


def test_default_scene_is_the_frozen_pair_called_as_before():
    cfg = _small()
    assert harness.scene_renderer(cfg).__file__ == synthclip.__file__
    assert harness.scene_truth(cfg).__file__ == truth.__file__
    clip = harness.make_clip(cfg, SEED, "cpu")
    fps, w, h, ro = 60.0, 96, 72, 0.01111
    want = synthclip.render_frames(SEED, clip.frame_index.tolist(), fps, w, h, ro, "cpu",
                                   synthclip.hero6_lens(w, h, ro))
    assert torch.equal(clip.frames, want)
    ts, rates = synthclip.gyro_log(SEED, 2.0, harness.true_delay(cfg, SEED), 2.0, 200.0, 1e-4)
    np.testing.assert_array_equal(clip.gyro_ts, ts)
    np.testing.assert_array_equal(clip.gyro_rates, rates)
    for got, direct in zip(clip.trajectory, synthclip.trajectory_params(SEED)):
        np.testing.assert_array_equal(got, direct)

    # the control's answers: the parent's direct calls of truth.py
    cell = harness.Cell("small", "small", "clip", 1, cfg, {"windows_per_request": "all"},
                        None, {}, [], [])
    reqs = control.control_requests(cell, clip)
    lens, grid = vars(clip.lens), truth.grid_points(w, h, 16)
    frames_a = (clip.syncpoints[:, None] + np.arange(21)[None]).reshape(-1)
    q = truth.true_tracks(synthclip.trajectory_params(SEED), lens, grid, frames_a, fps, h,
                          torch.bfloat16)
    rays = truth.undistort_ray(lens, q).reshape(len(clip.syncpoints), 21, len(grid), 3)
    delays = truth.window_delays(clip.syncpoints, fps, 20, clip.engine_delay, clip.drift,
                                 torch.bfloat16)
    assert len(reqs) == 1 and reqs[0].windows == list(range(len(clip.syncpoints)))
    assert reqs[0].presync == reqs[0].final == [float(d) for d in delays]
    for w_, (present, counts, r) in enumerate(reqs[0].tracks):
        assert present == 21 and (counts == len(grid)).all()
        assert torch.equal(r, rays[w_].permute(2, 0, 1).double())


def test_a_named_scene_is_its_two_modules():
    cfg = _config(ROOM)
    gen = harness.scene_renderer(cfg)
    assert type(gen).__name__ == "Room" and gen.d_ref == ROOM["texture_d_ref_m"]
    assert gen.render_frames.__code__.co_filename == room_gen.__file__
    assert gen.gyro_log is synthclip.gyro_log
    assert harness.scene_truth(cfg).__file__ == room.__file__
    for bad in ("../truth", "gen.room", "room; x"):
        with pytest.raises(ValueError):
            harness.scene_renderer(_config(dict(ROOM, model=bad)))
        with pytest.raises(ValueError):
            harness.scene_truth(_config(dict(ROOM, model=bad)))
    with pytest.raises(FileNotFoundError):
        harness.scene_truth(_config(dict(ROOM, model="no_such_scene")))


# (b), (c) -------------------------------------------------------------------


@pytest.mark.parametrize("pitch", [0.0, 30.0])
def test_no_translation_is_the_pure_rotation(pitch):
    g = room_gen.bind(dict(ROOM, mount_pitch_deg=pitch, translation_amp_m=[0.0, 0.0, 0.0]))
    traj = g.trajectory_params(SEED)
    grid, frames_a = truth.grid_points(W, H, 200), np.arange(0, 3600, 97)
    got = room.true_tracks(traj, _lens(), grid, frames_a, FPS, H)
    want = truth.true_tracks(synthclip.trajectory_params(SEED), _lens(), grid, frames_a, FPS, H)
    assert float((got - want).abs().max()) < 1e-9


@pytest.mark.parametrize("seed", [SEED, 7])
def test_a_track_shows_one_world_point(seed):
    traj = room_gen.bind(ROOM).trajectory_params(seed)
    lens, grid = _lens(), truth.grid_points(W, H, 200)
    frames_a = np.arange(0, 3600, 61)
    q = room.true_tracks(traj, lens, grid, frames_a, FPS, H)
    fa = torch.as_tensor(frames_a, dtype=torch.float64)[:, None]
    g = torch.as_tensor(grid)
    x_a = room.world_points(traj, lens, g[None], fa / FPS + RO * g[None, :, 1] / H)
    x_b = room.world_points(traj, lens, q, (fa + 1) / FPS + RO * q[..., 1] / H)
    inside = (q[..., 0] >= 0) & (q[..., 0] <= W - 1) & (q[..., 1] >= 0) & (q[..., 1] <= H - 1)
    assert inside.float().mean() > 0.9
    assert float((x_a - x_b).norm(dim=-1)[inside].max()) < 1e-9


# (d) ------------------------------------------------------------------------


def test_the_camera_keeps_its_distance_and_every_ray_leaves_the_box():
    traj = room_gen.bind(ROOM).trajectory_params(SEED)
    t = torch.arange(0.0, 60.0 + RO, 1e-3, dtype=torch.float64)
    c = room.centre(traj, t)
    for i, (lo, hi) in enumerate(ROOM["box_m"]):
        assert float(torch.minimum(c[:, i] - lo, hi - c[:, i]).min()) >= 0.2
    # every 8th pixel of 16 frames, at their row times
    vv, uu = torch.meshgrid(torch.arange(0.0, H, 8, dtype=torch.float64),
                            torch.arange(0.0, W, 8, dtype=torch.float64), indexing="ij")
    pix = torch.stack([uu, vv], -1).reshape(-1, 2)
    lo = torch.tensor([b[0] for b in ROOM["box_m"]], dtype=torch.float64)
    hi = torch.tensor([b[1] for b in ROOM["box_m"]], dtype=torch.float64)
    for f in np.linspace(0, 3599, 16).round():
        t_row = f / FPS + RO * pix[:, 1] / H
        c = room.centre(traj, t_row)
        x = room.world_points(traj, _lens(), pix, t_row)
        s = (x - c).norm(dim=-1)
        assert bool(torch.isfinite(s).all()) and float(s.min()) >= 0.2
        # on a wall, and inside the box
        wall = torch.minimum((x - lo).abs(), (hi - x).abs()).amin(dim=-1)
        assert float(wall.max()) < 1e-9
        assert bool(((x >= lo - 1e-9) & (x <= hi + 1e-9)).all())
        assert float(s.max() / s.min()) >= 3.0, f"depth spans {float(s.max() / s.min())}x"


@pytest.mark.parametrize("seed", [SEED, 3141592653])
def test_translation_moves_the_tracks(seed):
    """Over every pair of a 60 s clip at 60 fps, the grid points whose
    true position lies 32 px inside the frame: the true position minus
    where the rotation alone takes the point."""
    traj = room_gen.bind(ROOM).trajectory_params(seed)
    grid, frames_a = truth.grid_points(W, H, 200), np.arange(3599)
    q = room.true_tracks(traj, _lens(), grid, frames_a, FPS, H)
    rot = truth.true_tracks(traj["rotation"], _lens(), grid, frames_a, FPS, H)
    e = 32
    inside = ((q[..., 0] >= e) & (q[..., 0] <= W - 1 - e)
              & (q[..., 1] >= e) & (q[..., 1] <= H - 1 - e))
    part = (q - rot).norm(dim=-1)[inside]
    assert float(part.median()) >= 4.0 and float(torch.quantile(part, 0.9)) >= 10.0


# (e) ------------------------------------------------------------------------


def _bilinear(img: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    x0, y0 = q[:, 0].floor().long(), q[:, 1].floor().long()
    fx, fy = q[:, 0] - x0, q[:, 1] - y0
    i = img.double()
    return (i[y0, x0] * (1 - fx) * (1 - fy) + i[y0, x0 + 1] * fx * (1 - fy)
            + i[y0 + 1, x0] * (1 - fx) * fy + i[y0 + 1, x0 + 1] * fx * fy)


@pytest.mark.parametrize("seed", [3, SEED])
def test_frames_follow_the_truth_not_the_rotation_alone(seed):
    w, h = 96, 72
    g = room_gen.bind(ROOM)
    lens = synthclip.hero6_lens(w, h, RO)
    frames_a = list(range(0, 40, 4))
    idx = sorted(set(frames_a) | {f + 1 for f in frames_a})
    imgs = dict(zip(idx, g.render_frames(seed, idx, FPS, w, h, RO, "cpu", lens)))
    traj = g.trajectory_params(seed)
    grid = torch.tensor([[float(x), float(y)] for x in range(4, w - 4) for y in range(4, h - 4)],
                        dtype=torch.float64)
    q = room.true_tracks(traj, vars(lens), grid.numpy(), np.array(frames_a), FPS, h)
    rot = truth.true_tracks(traj["rotation"], vars(lens), grid.numpy(), np.array(frames_a),
                            FPS, h)
    err_true, err_rot = [], []
    for k, f in enumerate(frames_a):
        ok = torch.ones(len(grid), dtype=torch.bool)
        for p in (q[k], rot[k]):
            ok &= (p[:, 0] > 1) & (p[:, 0] < w - 2) & (p[:, 1] > 1) & (p[:, 1] < h - 2)
        a = imgs[f][grid[ok, 1].long(), grid[ok, 0].long()].double()
        err_true.append((_bilinear(imgs[f + 1], q[k][ok]) - a).abs())
        err_rot.append((_bilinear(imgs[f + 1], rot[k][ok]) - a).abs())
    e_true, e_rot = float(torch.cat(err_true).mean()), float(torch.cat(err_rot).mean())
    assert e_true < 0.9 * e_rot, (e_true, e_rot)


# a room cell through the harness ---------------------------------------------


@pytest.fixture(scope="module")
def room_root(tmp_path_factory) -> Path:
    """conftest's checkout with a tiny room configuration (conftest.TINY
    with `scene` ROOM) and its cell `tiny.room` under the mix `clip`."""
    spec = importlib.util.spec_from_file_location("portbench_conftest",
                                                  Path(__file__).with_name("conftest.py"))
    conf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conf)
    dst = conf.make_tiny_root(tmp_path_factory.mktemp("room"))
    pkg = dst / "portbench"
    cfg = json.loads((pkg / "configs/tiny.json").read_text())
    cfg.update(name="tiny_room")
    cfg["scene"].update(ROOM)
    (pkg / "configs/tiny_room.json").write_text(json.dumps(cfg))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    tiny = next(c for c in bench["configs"] if c["name"] == "tiny")
    bench["configs"].append(dict(tiny, name="tiny_room", file="portbench/configs/tiny_room.json"))
    bench["workloads"].append({"name": "tiny.room", "config": "tiny_room", "traffic": "clip",
                               "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny.clip" in m.get("workloads", []):
            m["workloads"].append("tiny.room")
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    (pkg / "limits/tiny.room.json").write_text((pkg / "limits/tiny.clip.json").read_text())
    return dst


def test_a_room_cell_runs_and_its_control_is_not_correct(room_root):
    out = harness.run("tiny.room", SEED, 0.5, False, "cpu", room_root)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"clip_s", "setup_s"}
    assert all(math.isfinite(c["value"]) for c in out["checks"].values()), out["checks"]
    cell = harness.find_cell("tiny.room", room_root)
    # the scene is the cell's checkout's, found as its other files are
    assert cell.root == room_root
    assert harness.scene_truth(cell.config, cell.root).__file__ == str(
        room_root / "portbench/reference/room.py")
    gen = harness.scene_renderer(cell.config, cell.root)
    assert gen.render_frames.__code__.co_filename == str(room_root / "portbench/gen/room.py")
    clip = harness.make_clip(cell.config, SEED, "cpu", render=False, root=cell.root)
    assert isinstance(clip.trajectory, dict)
    ok, checks = harness.judge(harness.compare(cell, clip, control.control_requests(cell, clip)),
                               cell.limits)
    assert not ok
    for name in ("track_err_px_p50", "track_err_px_p90", "sync_err_ms_max"):
        assert checks[name]["value"] > checks[name]["limit"], name
