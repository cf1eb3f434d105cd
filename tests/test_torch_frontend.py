"""The port's host ingest: telemetry parsing (GPMF and CAMM MP4, gcsv,
CSV, GyroFlow JSON, blackbox .bbl and CSV), the native C++ parser through
its ctypes hook, orientation, gyro integration, lens profiles, metrics,
the telemetry probe, stage timings, the track cache and `fill_gyro`.
Ports of tests/test_frontend.py (all but test_floor_model: utils/floors.py
is not ported), tests/test_native_gpmf.py and test_aux.py's Timings and
track-cache tests, plus parity with rssync_tpu's loader on every format."""

import ctypes
import fcntl
import io
import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rssync_tpu.frontend import telemetry as jtelemetry
from rssync_tpu_torch import create_sync_problem
from rssync_tpu_torch.analysis.metrics import sync_rmse, sync_rmse_from_csv, to_gyroflow_offset
from rssync_tpu_torch.frontend import probe, telemetry
from rssync_tpu_torch.frontend.integrate import integrate_gyro, integrate_gyro_fixed_rate
from rssync_tpu_torch.frontend.lens_profiles import load_lens_profile
from rssync_tpu_torch.ops.lens import Lens
from rssync_tpu_torch.utils import track_cache
from rssync_tpu_torch.utils.checks import SyncPanic
from rssync_tpu_torch.utils.timing import Timings

from gpmf_fixture import _box, write_bbl, write_camm_mp4, write_gpmf_mp4

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
NATIVE_DIR = REPO / "native" / "gpmf"


@pytest.fixture
def gyro_signal(rng):
    n = 1000
    t = np.arange(n) / 200.0
    g = np.stack(
        [np.sin(2 * np.pi * 0.7 * t), np.cos(2 * np.pi * 1.3 * t), 0.3 * np.sin(t)],
        axis=1,
    )
    return t, g


@pytest.fixture(scope="module")
def native_lib():
    """The native parser, built with `make -C native/gpmf` (serialized
    with a lock: the linker replaces the library, so a loaded copy stays
    valid) and loaded with the port's ABI struct."""
    lock_dir = REPO / "rssync_tpu_torch" / "build"
    lock_dir.mkdir(parents=True, exist_ok=True)
    with open(lock_dir / "gpmf_make.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", str(NATIVE_DIR)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(NATIVE_DIR / "librssync_gpmf.so"))
    lib.tp_load_gyro.restype = telemetry._TpGyroData
    lib.tp_load_gyro.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.tp_free.restype = None
    lib.tp_free.argtypes = [telemetry._TpGyroData]
    return lib


@pytest.fixture
def fresh_native(native_lib, monkeypatch):
    """Both packages re-probe for the (now built) native library."""
    for mod in (telemetry, jtelemetry):
        monkeypatch.setattr(mod, "_NATIVE_LIB", None)
        monkeypatch.setattr(mod, "_NATIVE_TRIED", False)
    return native_lib


def _load_native(lib, path, orient=None):
    res = lib.tp_load_gyro(str(path).encode(), orient.encode() if orient else None)
    assert res.samples > 0
    n = int(res.samples)
    ts = np.ctypeslib.as_array(res.timestamps, shape=(n,)).copy()
    gy = np.ctypeslib.as_array(res.gyro, shape=(n, 3)).copy()
    lib.tp_free(res)
    return ts, gy


# ---------------------------------------------------------------------------
# tests/test_frontend.py


def test_gpmf_mp4_roundtrip(tmp_path, gyro_signal):
    t, g = gyro_signal
    p = str(tmp_path / "clip.mp4")
    write_gpmf_mp4(p, g, rate_hz=200.0)
    data = telemetry.load_gyro(p, prefer_native=False)
    assert data.samples == len(g)
    np.testing.assert_allclose(data.gyro, g, atol=1e-3)  # int16 quantization
    np.testing.assert_allclose(data.timestamps, t, atol=1e-2)  # stts ms grid
    assert np.all(np.diff(data.timestamps) >= 0)


def test_camm_mp4_roundtrip(tmp_path, gyro_signal):
    t, g = gyro_signal
    p = str(tmp_path / "cam.mp4")
    write_camm_mp4(p, g, rate_hz=200.0)
    data = telemetry.load_gyro(p, prefer_native=False)
    assert data.samples == len(g)
    np.testing.assert_allclose(data.gyro, g, atol=1e-6)  # f32 payload
    np.testing.assert_allclose(data.timestamps, t, atol=1e-4)


def test_blackbox_csv(tmp_path, gyro_signal):
    t, g = gyro_signal
    p = str(tmp_path / "LOG00001.01.csv")
    deg = np.rad2deg(g)
    with open(p, "w") as f:
        f.write("loopIteration, time, axisP[0], gyroADC[0], gyroADC[1], gyroADC[2]\n")
        for i in range(len(t)):
            f.write(f"{i}, {t[i] * 1e6:.0f}, 0, "
                    f"{deg[i, 0]:.6f}, {deg[i, 1]:.6f}, {deg[i, 2]:.6f}\n")
    data = telemetry.load_gyro(p, prefer_native=False)
    assert data.samples == len(g)
    np.testing.assert_allclose(data.gyro, g, atol=1e-6)
    np.testing.assert_allclose(data.timestamps, t, atol=1e-6)


def test_gpmf_orin_normalization(tmp_path, gyro_signal):
    """ORIN='ZXy' means the raw columns are (z, x, -y); the parser
    normalizes back to XYZ."""
    t, g = gyro_signal
    raw = np.stack([g[:, 2], g[:, 0], -g[:, 1]], axis=1)
    p = str(tmp_path / "o.mp4")
    write_gpmf_mp4(p, raw, rate_hz=200.0, orin=b"ZXy", orio=b"XYZ")
    data = telemetry.load_gyro(p, prefer_native=False)
    np.testing.assert_allclose(data.gyro, g, atol=2e-3)


def test_orientation_string(gyro_signal):
    _, g = gyro_signal
    out = telemetry.apply_orientation(g, "yZX")
    np.testing.assert_allclose(out[:, 0], -g[:, 1])
    np.testing.assert_allclose(out[:, 1], g[:, 2])
    np.testing.assert_allclose(out[:, 2], g[:, 0])
    with pytest.raises(ValueError):
        telemetry.apply_orientation(g, "abc")


def test_gcsv_roundtrip(tmp_path, gyro_signal):
    t, g = gyro_signal
    p = tmp_path / "log.gcsv"
    lines = ["GYROFLOW IMU LOG", "version,1.3", "id,custom_logger",
             "tscale,0.005", "gscale,0.00122", "ascale,0.0001", "t,gx,gy,gz"]
    for i in range(len(t)):
        ticks = int(round(t[i] / 0.005))
        lines.append(f"{ticks},{g[i,0]/0.00122:.3f},{g[i,1]/0.00122:.3f},{g[i,2]/0.00122:.3f}")
    p.write_text("\n".join(lines))
    data = telemetry.load_gyro(str(p), prefer_native=False)
    np.testing.assert_allclose(data.timestamps, t, atol=1e-9)
    np.testing.assert_allclose(data.gyro, g, atol=1e-5)


def test_csv_roundtrip(tmp_path, gyro_signal):
    t, g = gyro_signal
    p = tmp_path / "log.csv"
    np.savetxt(p, np.column_stack([t, g]), delimiter=",", header="t,gx,gy,gz")
    data = telemetry.load_gyro(str(p), prefer_native=False)
    np.testing.assert_allclose(data.gyro, g, atol=1e-6)


def test_integration_matches_sequential(gyro_signal):
    """The doubling-scan integration equals the naive sequential fold."""
    from scipy.spatial.transform import Rotation

    t, g = gyro_signal
    got = integrate_gyro(t, g)
    q = Rotation.identity()
    seq = [np.array([1.0, 0, 0, 0])]
    for i in range(1, len(t)):
        q = Rotation.from_rotvec(g[i] * (t[i] - t[i - 1])) * q  # left multiply
        x, y, z, w = q.as_quat()
        seq.append(np.array([w, x, y, z]))
    seq = np.stack(seq)
    sign = np.sign(np.sum(got * seq, axis=1, keepdims=True))
    np.testing.assert_allclose(got, sign * seq, atol=5e-5)


def test_integration_fixed_rate(gyro_signal):
    _, g = gyro_signal
    out = integrate_gyro_fixed_rate(g, 200.0)
    assert out.shape == (len(g), 4)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-6)


def test_lens_profile_loader(tmp_path):
    p = tmp_path / "lens.txt"
    p.write_text(
        "other_cam 0.02 1000 1000 960 540 0.1 0.01 0.001 0.0001\n"
        "hero6_27k_43 0.01111 1186 1186 1355.389 1020.317 "
        "0.04440465777694087 0.01946789951179939 "
        "-0.004476697539343917 -0.002042912877740792\n"
    )
    lens = load_lens_profile(str(p), "hero6_27k_43")
    assert isinstance(lens, Lens)
    assert lens.ro == pytest.approx(0.01111)
    assert lens.fx == pytest.approx(1186)
    assert lens.k4 == pytest.approx(-0.002042912877740792)
    with pytest.raises(RuntimeError, match="preset"):
        load_lens_profile(str(p), "nope")


def test_sync_rmse_metric(tmp_path):
    import scipy.stats as st

    frames = np.arange(0, 1000, 100)
    true = 5.0 + 0.001 * frames
    noise = np.array([0.1, -0.1, 0.05, -0.05, 0.0, 0.1, -0.1, 0.0, 0.05, -0.05])
    q = sync_rmse(frames, true + noise)
    # the reference formula: std(linear fit - measured) (plot_sync.py:44-50)
    r = st.linregress(frames, true + noise)
    expect = np.std(r.intercept + r.slope * frames - (true + noise))
    assert q.rmse == pytest.approx(expect, abs=1e-9)
    assert q.slope == pytest.approx(r.slope, abs=1e-9)
    p = tmp_path / "sync.csv"
    np.savetxt(p, np.column_stack([frames, true + noise]), delimiter=",")
    assert sync_rmse_from_csv(str(p)).rmse == pytest.approx(q.rmse)


def test_to_gyroflow_offset():
    """The thesis's manual-verification convention (p.15/p.32): sign
    flip + readout/2 frame-center shift (+5.555 ms at 11.11 ms)."""
    assert to_gyroflow_offset(0.0, 0.01111) == pytest.approx(0.005555)
    assert to_gyroflow_offset(0.0123, 0.01111) == pytest.approx(-0.0123 + 0.005555)
    np.testing.assert_allclose(to_gyroflow_offset(np.array([0.0, 0.01]), 0.02), [0.01, 0.0])


def test_presync_grid_matches_reference_loop():
    """presync_grid reproduces the reference's f64 accumulation
    (core_private.cpp:69-70) bit for bit, including whether the last
    point lands inside the half-open bound."""
    from rssync_tpu_torch.core.presync import presync_grid

    for init, radius, step in [(0.0, 0.2, 0.002), (-0.0123, 0.05, 0.003),
                               (1.5, 0.1, 0.007), (0.0, 0.01, 0.002)]:
        ref = []
        d = init - radius
        while d < init + radius:
            ref.append(d)
            d += step
        assert presync_grid(init, radius, step) == ref


def test_bad_gyro_file(tmp_path):
    p = tmp_path / "junk.gcsv"
    p.write_text("hello\nworld\n")
    with pytest.raises(SyncPanic):
        telemetry.load_gyro(str(p), prefer_native=False)


def _probe_to_text(path, orient=None):
    out = io.StringIO()
    ok = probe.probe_file(str(path), orient, out=out)
    return ok, out.getvalue()


def test_probe_gpmf_mp4(tmp_path):
    """The first-contact kit dumps box tree, track candidates, KLV tree,
    sample counts and rate estimate of a healthy GPMF MP4."""
    n = 400
    t = np.arange(n) / 200.0
    g = np.stack([np.sin(3 * t), np.cos(2 * t), 0.5 * t], axis=1)
    p = tmp_path / "clip.mp4"
    write_gpmf_mp4(str(p), g, rate_hz=200.0)
    ok, text = _probe_to_text(p)
    assert ok
    for needle in ("box tree", "moov", "trak", "GPMF", "KLV tree", "GYRO", "SCAL",
                   "samples: 400", "200.00 Hz", "strictly increasing: True", "finite: True"):
        assert needle in text, f"probe output missing {needle!r}:\n{text}"


def test_probe_reports_where_parsing_stopped(tmp_path):
    """A truncated MP4 gives a diagnosis (where the box walk stopped,
    which parse raised), not a silent empty result."""
    p = tmp_path / "clip.mp4"
    write_gpmf_mp4(str(p), np.zeros((400, 3)), rate_hz=200.0)
    trunc = tmp_path / "trunc.mp4"
    trunc.write_bytes(p.read_bytes()[:1000])
    ok, text = _probe_to_text(trunc)
    assert not ok
    assert "box walk stopped" in text
    assert "PARSE FAILED" in text
    assert "at " in text  # traceback frames locating the failure


def test_probe_gcsv_and_cli(tmp_path):
    """Text formats get a header dump; the CLI returns 0/1."""
    p = tmp_path / "log.gcsv"
    p.write_text("GYROFLOW IMU LOG\ntscale,0.001\ngscale,1\nascale,1\nt,gx,gy,gz\n"
                 + "".join(f"{i},0.1,0.2,0.3\n" for i in range(100)))
    ok, text = _probe_to_text(p)
    assert ok
    assert "first" in text and "tscale" in text
    assert probe.main(["--probe", str(p)]) == 0
    bad = tmp_path / "junk.gcsv"
    bad.write_text("hello\nworld\n")
    assert probe.main(["--probe", str(bad)]) == 1


def test_probe_prints_true_start_of_largesize_box(tmp_path):
    """A box with a 64-bit largesize header and a small payload: the box
    walk reports the 16-byte header it consumed, and the dump prints the
    box's true start (rssync_tpu's probe re-derives the header from the
    payload size and prints 8 bytes too far)."""
    payload = b"\0" * 24
    big = struct.pack(">I", 1) + b"free" + struct.pack(">Q", 16 + len(payload)) + payload
    blob = _box(b"ftyp", b"isom") + big + _box(b"skip", b"abcd")
    boxes = list(telemetry._iter_boxes(blob, 0, len(blob)))
    assert [(t, ps, pe, h) for t, ps, pe, h in boxes] == [
        (b"ftyp", 8, 12, 8), (b"free", 28, 52, 16), (b"skip", 60, 64, 8)]
    out = io.StringIO()
    probe._dump_boxes(blob, 0, len(blob), out)
    assert "free  [12..52)  payload 24 B" in out.getvalue()
    assert "skip  [52..64)  payload 4 B" in out.getvalue()
    # the CLI entry runs as a module
    p = tmp_path / "big.mp4"
    p.write_bytes(blob)
    proc = subprocess.run(
        [sys.executable, "-m", "rssync_tpu_torch.frontend.probe", "--probe", str(p)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert "free  [12..52)" in proc.stdout and proc.returncode == 1


# ---------------------------------------------------------------------------
# tests/test_native_gpmf.py


@pytest.fixture
def fixture_mp4(tmp_path):
    n = 777
    t = np.arange(n) / 200.0
    g = np.stack([np.sin(3 * t), np.cos(2 * t), 0.5 * np.sin(5 * t)], axis=1)
    p = str(tmp_path / "clip.mp4")
    write_gpmf_mp4(p, g, rate_hz=200.0, samples_per_payload=190)
    return p, t, g


def test_native_matches_python(native_lib, fixture_mp4):
    path, t, g = fixture_mp4
    ts_n, gy_n = _load_native(native_lib, path)
    py = telemetry.parse_mp4_gpmf(path)
    np.testing.assert_allclose(ts_n, py.timestamps, atol=1e-12)
    np.testing.assert_allclose(gy_n, py.gyro, atol=1e-12)
    np.testing.assert_allclose(gy_n, g, atol=1e-3)


def test_native_orientation(native_lib, fixture_mp4):
    path, _, g = fixture_mp4
    _, gy = _load_native(native_lib, path, orient="yZX")
    np.testing.assert_allclose(gy[:, 0], -g[:, 1], atol=1e-3)
    np.testing.assert_allclose(gy[:, 1], g[:, 2], atol=1e-3)
    np.testing.assert_allclose(gy[:, 2], g[:, 0], atol=1e-3)


def test_native_orin_remap(native_lib, tmp_path):
    t = np.arange(300) / 200.0
    g = np.stack([np.sin(3 * t), np.cos(2 * t), 0.4 * t], axis=1)
    raw = np.stack([g[:, 2], g[:, 0], -g[:, 1]], axis=1)
    p = str(tmp_path / "o.mp4")
    write_gpmf_mp4(p, raw, rate_hz=200.0, orin=b"ZXy", orio=b"XYZ")
    _, gy = _load_native(native_lib, p)
    np.testing.assert_allclose(gy, g, atol=2e-3)


def test_native_rejects_garbage(native_lib, tmp_path):
    p = tmp_path / "junk.mp4"
    p.write_bytes(b"not an mp4 at all, just bytes" * 10)
    res = native_lib.tp_load_gyro(str(p).encode(), None)
    assert res.samples == 0
    native_lib.tp_free(res)


def test_dispatcher_prefers_native(fresh_native, fixture_mp4):
    """load_gyro with prefer_native finds the library relative to the
    port's package and uses it for MP4s."""
    path, _, g = fixture_mp4
    data = telemetry.load_gyro(path, prefer_native=True)
    np.testing.assert_allclose(data.gyro, g, atol=1e-3)
    assert telemetry._NATIVE_LIB is not None
    assert Path(telemetry._NATIVE_LIB._name).resolve() == (NATIVE_DIR / "librssync_gpmf.so")


def test_native_camm(native_lib, tmp_path):
    t = np.arange(500) / 200.0
    g = np.stack([np.sin(2 * t), np.cos(3 * t), 0.2 * t], axis=1)
    p = str(tmp_path / "camm.mp4")
    write_camm_mp4(p, g, rate_hz=200.0)
    ts, gy = _load_native(native_lib, p)
    py = telemetry.parse_mp4_camm(p)
    np.testing.assert_array_equal(ts, py.timestamps)
    np.testing.assert_array_equal(gy, py.gyro)
    np.testing.assert_allclose(gy, g, atol=1e-6)  # f32 payload
    np.testing.assert_allclose(ts, t, atol=1e-4)


def _gyroflow_samples(n=40):
    return [{"ts": i * 5.0, "gyro": [0.1 * i, -3.5, 2.0], "accl": [0, 0, 9.8]}
            for i in range(n)]


def test_native_gyroflow_json(native_lib, tmp_path):
    samples = _gyroflow_samples()
    p1 = tmp_path / "a.json"
    p1.write_text(json.dumps({"version": 2, "raw_imu": samples}))
    p2 = tmp_path / "b.json"
    p2.write_text(json.dumps(samples))
    for p in (p1, p2):
        ts, gy = _load_native(native_lib, str(p))
        py = telemetry.parse_gyroflow_json(str(p))
        np.testing.assert_array_equal(ts, py.timestamps)
        np.testing.assert_allclose(gy, py.gyro, rtol=1e-15)
        assert ts[1] == 0.005  # ms -> s
        np.testing.assert_allclose(gy[10, 1], np.deg2rad(-3.5))


def _native_samples(lib, path):
    res = lib.tp_load_gyro(str(path).encode(), None)
    n = int(res.samples)
    if n:
        # touch every output byte: a bogus pointer or size faults here
        ts = np.ctypeslib.as_array(res.timestamps, shape=(n,)).copy()
        gy = np.ctypeslib.as_array(res.gyro, shape=(n, 3)).copy()
        assert ts.shape == (n,) and gy.shape == (n, 3)
    lib.tp_free(res)
    return n


def test_native_survives_truncations_and_lying_sizes(native_lib, tmp_path, rng):
    """Malformed MP4s return cleanly: truncations at every header byte
    and near the end, and boxes whose sizes lie, yield no samples (or a
    valid subset); a native fault would kill the process."""
    g = np.stack([np.sin(np.arange(300) / 10.0)] * 3, axis=1)
    p = tmp_path / "t.mp4"
    write_gpmf_mp4(str(p), g, rate_hz=200.0, samples_per_payload=64)
    data = p.read_bytes()
    q = tmp_path / "trunc.mp4"
    for cut in sorted(set(list(range(0, 64)) + [len(data) - k for k in range(1, 40)]
                          + list(rng.integers(0, len(data), 60)))):
        q.write_bytes(data[:cut])
        _native_samples(native_lib, q)

    def box(fourcc, payload, size=None):
        return struct.pack(">I", 8 + len(payload) if size is None else size) + fourcc + payload

    for i, payload in enumerate([
        box(b"ftyp", b"isom") + box(b"moov", b"\0" * 8, size=1 << 30),
        box(b"moov", b"", size=0) + b"\0" * 64,
        struct.pack(">I", 1) + b"moov" + struct.pack(">Q", (1 << 64) - 9),
        box(b"moov", b"", size=3),
        box(b"moov", box(b"trak", b"", size=0) + b"\0" * 32),
    ]):
        q.write_bytes(payload)
        assert _native_samples(native_lib, q) == 0, f"case {i}"
        # the port's Python walk refuses the same boxes without looping
        with pytest.raises(Exception):
            telemetry.parse_mp4(str(q))


def test_python_parser_never_crashes(tmp_path, rng):
    """The port's Python MP4 walker on a mutation corpus: any exception
    type is fine, a hang is not."""
    g = np.stack([np.cos(np.arange(200) / 7.0)] * 3, axis=1)
    p = tmp_path / "m.mp4"
    write_gpmf_mp4(str(p), g, rate_hz=200.0, samples_per_payload=64)
    data = bytearray(p.read_bytes())
    q = tmp_path / "mut.mp4"
    for _ in range(80):
        mut = bytearray(data)
        for _ in range(int(rng.integers(1, 9))):
            mut[int(rng.integers(0, len(mut)))] = int(rng.integers(0, 256))
        q.write_bytes(bytes(mut))
        try:
            telemetry.parse_mp4(str(q))
        except Exception:
            pass


def _write_gcsv(path, rng, n=120):
    with open(path, "w") as f:
        f.write("GYROFLOW IMU LOG\nversion,1.3\nid,custom\norientation,xyz\n"
                "tscale,0.001\ngscale,0.00122173\nt,gx,gy,gz\n")
        for i in range(n):
            f.write(f"{i},{rng.integers(-900, 900)},{rng.integers(-900, 900)},"
                    f"{rng.integers(-900, 900)}\n")


def _write_plain_csv(path, rng, n=60):
    with open(path, "w") as f:
        f.write("t,gx,gy,gz\n")
        for i in range(n):
            f.write(f"{i * 0.005},{rng.normal():.9g},{rng.normal():.9g},{rng.normal():.9g}\n")


def _write_blackbox_csv(path, rng, n=80):
    with open(path, "w") as f:
        f.write('loopIteration, time, axisP[0], "gyroADC[0]", gyroADC[1], gyroADC[2]\n')
        for i in range(n):
            f.write(f"{i},{1000 + i * 312},{rng.normal():.3f},{rng.normal():.4f},"
                    f"{rng.normal():.4f},{rng.normal():.4f}\n")


def _write_bbl(path, rng, n=150, **kw):
    times = 1000 + np.cumsum(rng.integers(280, 350, n))
    raw = rng.integers(-30000, 30000, (n, 3))
    write_bbl(str(path), times, raw, 1.31e-7, **kw)
    return times, raw


def _write_json(path, rng, n=90):
    path.write_text(json.dumps({"raw_imu": [
        {"ts": 1.25 * i, "gyro": [float(v) for v in rng.normal(size=3) * 50]}
        for i in range(n)]}))


def _write_gpmf(path, rng, n=400):
    write_gpmf_mp4(str(path), rng.normal(size=(n, 3)) * 0.5, rate_hz=200.0,
                   samples_per_payload=150)


def _write_camm(path, rng, n=300):
    write_camm_mp4(str(path), rng.normal(size=(n, 3)), rate_hz=200.0)


_TEXT_FORMATS = {
    "gcsv": ("a.gcsv", _write_gcsv, "parse_gcsv"),
    "plain_csv": ("a.csv", _write_plain_csv, "parse_csv"),
    "blackbox_csv": ("bb.csv", _write_blackbox_csv, "parse_blackbox_csv"),
    "bbl": ("a.bbl", _write_bbl, "parse_blackbox_bbl"),
}
#: every format load_gyro reads: (file name, writer)
FORMATS = {
    "gpmf": ("g.mp4", _write_gpmf), "camm": ("c.mp4", _write_camm),
    "gyroflow_json": ("a.json", _write_json),
    **{k: v[:2] for k, v in _TEXT_FORMATS.items()},
}


@pytest.mark.parametrize("fmt", sorted(_TEXT_FORMATS))
def test_native_text_format_parity(native_lib, tmp_path, rng, fmt):
    """Native and Python parsers give bit-identical output, with and
    without an orientation string, for each text format."""
    fname, writer, pyfunc = _TEXT_FORMATS[fmt]
    path = tmp_path / fname
    writer(path, rng)
    py = getattr(telemetry, pyfunc)(str(path))
    ts_n, gy_n = _load_native(native_lib, str(path))
    np.testing.assert_array_equal(ts_n, py.timestamps)
    np.testing.assert_array_equal(gy_n, py.gyro)
    _, gy_o = _load_native(native_lib, str(path), orient="zXy")
    np.testing.assert_array_equal(gy_o, telemetry.apply_orientation(py.gyro, "zXy"))


def test_bbl_decodes_known_values(tmp_path, rng):
    """The .bbl decoder recovers the exact raw rows the fixture encoder
    wrote (I/P frames, TAG2_3S32 deltas, straight-line time, S frames,
    events)."""
    path = tmp_path / "k.bbl"
    times, raw = _write_bbl(path, rng, with_s_frames=True)
    d = telemetry.parse_blackbox_bbl(str(path))
    scale = float(np.float32(1.31e-7))  # hex-float header round-trip
    np.testing.assert_allclose(d.timestamps, times * 1e-6, atol=1e-12)
    np.testing.assert_allclose(d.gyro, raw * (scale * 1e6), rtol=1e-12)


def test_bbl_without_scale_header_uses_mpu_lsb(tmp_path, rng):
    """Absent gyro_scale, raw units are 16.4 LSB/(deg/s)."""
    times = 1000 + np.arange(20) * 312
    raw = rng.integers(-3000, 3000, (20, 3))
    path = tmp_path / "ns.bbl"
    write_bbl(str(path), times, raw, 1.0)
    path.write_bytes(path.read_bytes().replace(b"H gyro_scale:0x3f800000\n", b""))
    d = telemetry.parse_blackbox_bbl(str(path))
    np.testing.assert_allclose(d.gyro, np.deg2rad(raw / 16.4), rtol=1e-12)


def test_bbl_dispatch_by_extension_and_content(fresh_native, tmp_path, rng, monkeypatch):
    """load_gyro routes .bbl by extension and blackbox magic by content
    (no extension), native first, and the Python path agrees."""
    path = tmp_path / "d.bbl"
    _write_bbl(path, rng, n=40)
    a = telemetry.load_gyro(str(path))
    noext = tmp_path / "noext"
    noext.write_bytes(path.read_bytes())
    np.testing.assert_array_equal(a.gyro, telemetry.load_gyro(str(noext)).gyro)
    monkeypatch.setattr(telemetry, "_NATIVE_LIB", None)
    monkeypatch.setattr(telemetry, "_NATIVE_TRIED", True)  # force Python
    np.testing.assert_array_equal(a.gyro, telemetry.load_gyro(str(path)).gyro)


@pytest.mark.parametrize("fmt", sorted(_TEXT_FORMATS))
def test_text_format_fuzz(native_lib, tmp_path, rng, fmt):
    """Truncations and byte mutations never crash either parser: native
    returns empty or valid arrays, Python data or SyncPanic/ValueError."""
    fname, writer, pyfunc = _TEXT_FORMATS[fmt]
    base = tmp_path / fname
    writer(base, rng)
    blob = bytearray(base.read_bytes())
    cases = [bytes(blob[: int(len(blob) * frac)]) for frac in (0.03, 0.3, 0.7, 0.97)]
    for _ in range(30):
        m = bytearray(blob)
        for _ in range(rng.integers(1, 8)):
            m[rng.integers(0, len(m))] = rng.integers(0, 256)
        cases.append(bytes(m))
    for i, payload in enumerate(cases):
        p = tmp_path / f"fuzz{i}_{fname}"
        p.write_bytes(payload)
        _native_samples(native_lib, p)
        try:
            getattr(telemetry, pyfunc)(str(p))
        except (SyncPanic, ValueError, IndexError):
            pass


# ---------------------------------------------------------------------------
# parity with rssync_tpu's loader


@pytest.mark.parametrize("prefer_native", [True, False])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_load_gyro_matches_rssync_tpu(fresh_native, tmp_path, rng, fmt, prefer_native):
    """Every format, through the native and the Python parser, with and
    without an orientation string: the port's load_gyro returns the
    arrays rssync_tpu's does, bit for bit."""
    fname, writer = FORMATS[fmt]
    path = tmp_path / fname
    writer(path, rng)
    for orient in (None, "zXy"):
        got = telemetry.load_gyro(str(path), orient, prefer_native=prefer_native)
        want = jtelemetry.load_gyro(str(path), orient, prefer_native=prefer_native)
        assert got.samples == want.samples > 10
        np.testing.assert_array_equal(got.timestamps, want.timestamps)
        np.testing.assert_array_equal(got.gyro, want.gyro)
    if prefer_native:  # the native parser served it
        assert telemetry._native_load(str(path), None) is not None


# ---------------------------------------------------------------------------
# tests/test_aux.py: Timings and the track cache


def test_timings_registry():
    t = Timings()
    for name in ("a", "a", "b"):
        with t.stage(name):
            pass
    assert t.stages["a"].calls == 2 and t.stages["b"].calls == 1
    assert t.stages["a"].min_s <= t.stages["a"].max_s
    rep = t.report()
    assert "a" in rep and "b" in rep
    assert t.as_dict()["a"]["calls"] == 2


@pytest.fixture(scope="module")
def small_scene():
    from synthetic import make_scene

    return make_scene(seed=2, true_delay=0.01, n_frames=5, n_points=20)


def test_track_cache_roundtrip(tmp_path, small_scene):
    sp1 = create_sync_problem(device="cpu")
    for f, d in small_scene.frames.items():
        sp1.set_track_result(f, *d)
    p = str(tmp_path / "tracks.npz")
    track_cache.save_tracks(sp1, p)
    sp2 = create_sync_problem(device="cpu")
    assert track_cache.load_tracks(sp2, p) == 5
    for f in small_scene.frames:
        a, b = sp1._frame_data[f], sp2._frame_data[f]
        for name in ("ts_a", "ts_b", "rays_a", "rays_b"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_track_cache_or_compute(tmp_path, small_scene):
    calls = []

    def fill(sp):
        def compute():
            calls.append(1)
            for f, d in small_scene.frames.items():
                sp.set_track_result(f, *d)
        return compute

    sp = create_sync_problem(device="cpu")
    assert not track_cache.tracks_cached_or_compute(sp, str(tmp_path), "k1", fill(sp))
    assert len(calls) == 1
    assert Path(track_cache.cache_path(str(tmp_path), "k1")).exists()
    sp2 = create_sync_problem(device="cpu")
    assert track_cache.tracks_cached_or_compute(sp2, str(tmp_path), "k1", fill(sp2))
    assert len(calls) == 1 and len(sp2._frame_data) == 5
    # no cache directory: always compute
    assert not track_cache.tracks_cached_or_compute(sp2, None, "k1", fill(sp2))
    assert len(calls) == 2


def test_track_cache_key_follows_file_and_config(tmp_path):
    from rssync_tpu.utils import track_cache as jtrack_cache

    video = tmp_path / "v.mp4"
    video.write_bytes(b"\0" * 64)
    args = (str(video), 0, 100, 200, "lk", (1.0, 2.0), [(0, 10)])
    key = track_cache.cache_key(*args)
    assert key == jtrack_cache.cache_key(*args)
    assert key != track_cache.cache_key(str(video), 0, 100, 200, "dis", (1.0, 2.0), [(0, 10)])
    assert track_cache.cache_path("d", key) == f"d/tracks_{key}.npz"


# ---------------------------------------------------------------------------
# fill_gyro


def test_fill_gyro_matches_rssync_tpu_and_set_gyro_rates(fresh_native, tmp_path, monkeypatch):
    """A gyro log written as .gcsv: the port's fill_gyro gives the
    spline table, rate and start rssync_tpu's fill_gyro gives, through
    the native and the Python parser, and the in-memory intake
    (set_gyro_rates) of the parsed rates gives the same table."""
    import rssync_tpu
    from rssync_tpu.pipeline.recipe import fill_gyro as jfill_gyro
    from rssync_tpu_torch.pipeline.recipe import fill_gyro, set_gyro_rates

    t = np.arange(2000) / 200.0
    g = np.stack([np.sin(2.1 * t), 0.4 * np.cos(1.3 * t), 0.2 * np.sin(5 * t)], axis=1)
    path = tmp_path / "log.gcsv"
    path.write_text("GYROFLOW IMU LOG\ntscale,0.000001\ngscale,0.0001\nt,gx,gy,gz\n"
                    + "".join(f"{int(round(ti * 1e6))},{row[0] / 1e-4:.0f},{row[1] / 1e-4:.0f},"
                              f"{row[2] / 1e-4:.0f}\n" for ti, row in zip(t, g)))
    jsp = rssync_tpu.create_sync_problem(seed=0)
    jfill_gyro(jsp, str(path), "xyz")
    tables = []
    for native in (True, False):
        if not native:  # force the Python parser
            monkeypatch.setattr(telemetry, "_NATIVE_LIB", None)
            monkeypatch.setattr(telemetry, "_NATIVE_TRIED", True)
        sp = create_sync_problem(device="cpu")
        fill_gyro(sp, str(path), "xyz")
        assert (telemetry._NATIVE_LIB is not None) == native
        assert sp._sample_rate == jsp._sample_rate == 200.0
        assert sp._quats_start == jsp._quats_start
        np.testing.assert_array_equal(sp.spline_table.coeffs.numpy(),
                                      np.asarray(jsp.spline_table.coeffs))
        tables.append(sp.spline_table.coeffs)
    data = telemetry.load_gyro(str(path), prefer_native=False)
    mem = create_sync_problem(device="cpu")
    set_gyro_rates(mem, data.timestamps, data.gyro, "xyz")
    torch.testing.assert_close(mem.spline_table.coeffs, tables[0], rtol=0, atol=0)
