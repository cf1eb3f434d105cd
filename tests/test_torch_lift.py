"""`ops/lens.py::lift_points`, emission's undistort and ray lift in one
call: on the CPU it is the plain chain `rays_from_normalized(
undistort_points(...))`, bit for bit; on a card (`-m cuda`) the kernel of
csrc/lift_rays.cu is bit-equal to that chain. Emission (`emit_track_block`,
`lift_rays`) goes through it. No JAX here: the card tests run in this file.

    python -m pytest --noconftest -m cuda tests/test_torch_lift.py
"""

import numpy as np
import pytest
import torch

from rssync_tpu_torch.frontend import tracking as T
from rssync_tpu_torch.ops import _kernels
from rssync_tpu_torch.ops import lens as L
from rssync_tpu_torch.utils.timing import recording

torch.set_num_threads(2)

#: the hero6 lens and the 640x480 k1-only lens of test_torch_lens.py
LENSES = {
    "hero6": (L.Lens(ro=0.0111, fx=1186.0, fy=1190.0, cx=1355.2, cy=1020.7,
                     k1=0.0444, k2=0.0195, k3=-0.00448, k4=-0.00204), (2704, 2028)),
    "k1": (L.Lens(ro=0.01, fx=500.0, fy=500.0, cx=320.0, cy=240.0, k1=0.02), (640, 480)),
}
#: pixels far outside the frame: Newton's first step from pi/4 leaves
#: (0, pi/2) and the safeguard halves it back
FAR = ((-5000.0, -4000.0), (20000.0, 15000.0), (1e5, -3e4))


def _pixels(seed, n, lens, size):
    """n pixels over the frame and a little past it; the raw-zero corner,
    the principal point (theta_d = 0) and FAR first."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-20.0, 1.0, size=(n, 2)) + rng.uniform(0.0, 1.0, size=(n, 2)) * size
    edge = [(0.0, 0.0), (lens.cx, lens.cy), *FAR]
    pts[: len(edge)] = edge
    return pts


def _first_newton_step(lens, px, py):
    """rssync_tpu_torch's first Newton step from pi/4, in float64, before
    the safeguard."""
    x, y = (px - lens.cx) / lens.fx, (py - lens.cy) / lens.fy
    td = np.hypot(x, y)
    t = np.pi / 4
    t2 = t * t
    cur = t * (1 + t2 * (lens.k1 + t2 * (lens.k2 + t2 * (lens.k3 + t2 * lens.k4))))
    dcur = 1 + 3 * lens.k1 * t2 + 5 * lens.k2 * t2**2 + 7 * lens.k3 * t2**3 + 9 * lens.k4 * t2**4
    return t - (cur - td) / dcur


#: points of the CPU comparisons: at most 2048, PyTorch's grain for tan,
#: cos and sqrt on the CPU, so that each runs on one thread; above it they
#: are split across threads, and once in a run of the whole suite two calls
#: of the plain chain on 2080 points gave different bits
CPU_POINTS = 2000


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(LENSES))
def test_lift_points_is_the_plain_chain_on_cpu(name, dtype):
    lens, size = LENSES[name]
    pts = torch.as_tensor(_pixels(3, CPU_POINTS, lens, size), dtype=dtype)
    for px, py in FAR:  # these points take the safeguard
        assert not 0.0 < _first_newton_step(lens, px, py) < np.pi / 2
    got = L.lift_points(lens, pts)
    want = L.rays_from_normalized(L.undistort_points(lens, pts))
    assert got.dtype == dtype and got.shape == (CPU_POINTS, 3)
    assert torch.equal(got, want)
    assert torch.equal(got[0], torch.tensor([0.0, 0.0, 1.0], dtype=dtype))  # raw zero
    assert torch.equal(got[1], torch.tensor([0.0, 0.0, 1.0], dtype=dtype))  # theta_d = 0
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(torch.linalg.vector_norm(got.double(), dim=-1),
                               torch.ones(CPU_POINTS, dtype=torch.float64), rtol=0, atol=1e-6)


def test_lift_points_keeps_leading_dims():
    lens, size = LENSES["hero6"]
    pts = torch.as_tensor(_pixels(4, 48, lens, size), dtype=torch.float32)
    got = L.lift_points(lens, pts.reshape(4, 12, 2))
    assert got.shape == (4, 12, 3)
    assert torch.equal(got.reshape(48, 3), L.lift_points(lens, pts))
    assert L.lift_points(lens, torch.zeros((0, 2))).shape == (0, 3)


@pytest.mark.parametrize("bad,error", [
    (torch.zeros((5, 2), dtype=torch.float16), TypeError),
    (torch.zeros((5, 2), dtype=torch.int32), TypeError),
    (torch.zeros((5, 3)), ValueError),
    (torch.zeros(()), ValueError),
    (torch.zeros((2, 5)).T, ValueError),  # (5, 2), not contiguous
])
def test_lift_points_refuses_bad_points(bad, error):
    with pytest.raises(error):
        L.lift_points(LENSES["hero6"][0], bad)


def test_kernel_sources_list_lift_rays():
    assert "lift_rays.cu" in _kernels.SOURCES
    src = (_kernels.CSRC / "lift_rays.cu").read_text()
    assert "int lift_rays_launch(" in src and "const char* lift_rays_error_string(" in src


def test_kernel_constants_are_the_plain_versions_scalars():
    """float32: each constant is what `undistort_points` meets on a card,
    rounded to float32 (exact in float32); float64: the lens itself."""
    lens = LENSES["hero6"][0]
    c32 = L.kernel_constants(lens, torch.float32)
    assert len(c32) == 14
    assert all(float(np.float32(v)) == v for v in c32)
    assert c32[2] == float(np.float32(1.0) / np.float32(lens.fx))
    assert c32[8] == float(np.float32(3.0 * float(np.float32(lens.k1))))
    c64 = L.kernel_constants(lens, torch.float64)
    assert c64[:4] == [lens.cx, lens.cy, 1.0 / lens.fx, 1.0 / lens.fy]
    assert c64[4:8] == [lens.k1, lens.k2, lens.k3, lens.k4]
    assert c64[12:] == [np.pi / 2, np.pi / 4]


class _Recorder:
    def __init__(self):
        self.calls = []

    def set_track_result(self, frame, ts_a, ts_b, rays_a, rays_b):
        self.calls.append((frame, *(np.array(x, np.float64) for x in (ts_a, ts_b, rays_a, rays_b))))


def _block(seed=12, P=5):
    lens, (w, h) = LENSES["hero6"]
    pts = T.grid_points(w, h, 200)
    rng = np.random.default_rng(seed)
    tracked = (pts[None] + rng.normal(scale=4.0, size=(P, *pts.shape))).astype(np.float32)
    return lens, h, pts, tracked, 50.0 + np.arange(P + 1) / 60.0


def test_emit_track_block_equals_emit_track_result():
    lens, h, pts, tracked, frame_ts = _block()
    P = len(tracked)
    got, block = _Recorder(), _Recorder()
    pt = torch.as_tensor(pts, dtype=torch.float32)
    for i in range(P):
        T.emit_track_result(got, lens, pts, pt, h, 30 + i, tracked[i], frame_ts[i],
                            frame_ts[i + 1])
    T.emit_track_block(block, lens, pts, torch.as_tensor(tracked), np.arange(30, 30 + P),
                       frame_ts, h)
    assert [c[0] for c in got.calls] == [c[0] for c in block.calls] == list(range(30, 30 + P))
    for g, b in zip(got.calls, block.calls):
        for x, y in zip(g[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
    ra, rb = T.lift_rays(lens, pt, torch.as_tensor(tracked[2]))
    np.testing.assert_array_equal(ra.double().numpy(), block.calls[2][3])
    np.testing.assert_array_equal(rb.double().numpy(), block.calls[2][4])


def test_recording_shows_no_lift_launch_on_cpu():
    """Only a kernel launch counts `lift_launches`: the CPU runs the plain
    chain, so a recording of emit_track_block has both `emit.lift` spans
    and no count, and the launch counters stay at zero."""
    lens, h, pts, tracked, frame_ts = _block(P=3)
    L.reset_launch_counters()
    with recording() as rec:
        T.emit_track_block(_Recorder(), lens, pts, torch.as_tensor(tracked), np.arange(3),
                           frame_ts, h)
    summary = rec.summary()
    assert summary["emit.lift"]["calls"] == 2
    assert rec.counted("lift_launches") == 0
    assert L.LAUNCHES["lift_points"] == 0 and not L.LAUNCH_SHAPES["lift_points"]


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(LENSES))
@pytest.mark.parametrize("n", [130, 2080, 5])
def test_lift_kernel_matches_plain_on_card(cuda, name, dtype, n):
    lens, size = LENSES[name]
    pts = torch.as_tensor(_pixels(n, n, lens, size), dtype=dtype, device=cuda)
    L.reset_launch_counters()
    got = L.lift_points(lens, pts)
    want = L.lift_points_ref(lens, pts)
    torch.cuda.synchronize()
    assert L.LAUNCHES["lift_points"] == 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_emission_on_card_launches_the_kernel_only(cuda, monkeypatch):
    """emit_track_block on the card: 2 launches a block, counted under
    `emit.lift`; no CUDA input reaches the plain chain; the rays equal the
    CPU's within float32 rounding of tan/cos."""
    lens, h, pts, tracked, frame_ts = _block(P=4)
    cpu = _Recorder()
    T.emit_track_block(cpu, lens, pts, torch.as_tensor(tracked), np.arange(4), frame_ts, h)

    def refuse(*a, **k):
        raise AssertionError("a CUDA input reached lift_points_ref")

    monkeypatch.setattr(L, "lift_points_ref", refuse)
    card = _Recorder()
    with recording() as rec:
        T.emit_track_block(card, lens, pts, torch.as_tensor(tracked, device=cuda), np.arange(4),
                           frame_ts, h)
    assert rec.summary()["emit.lift"]["counts"] == {"lift_launches": 2}
    for c, g in zip(cpu.calls, card.calls):
        for x, y in zip(c[1:], g[1:]):
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_lift_kernel_refused_launch_raises(cuda, monkeypatch):
    class Lib:
        def lift_rays_launch(self, *args):
            return 1  # cudaErrorInvalidValue

        def lift_rays_error_string(self, code):
            return b"invalid argument"

    monkeypatch.setattr(_kernels, "load", lambda: Lib())
    with pytest.raises(RuntimeError, match="invalid argument"):
        L.lift_points(LENSES["k1"][0], torch.zeros((3, 2), device=cuda))
