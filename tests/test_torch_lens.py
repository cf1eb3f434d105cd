"""Parity of the port's lens model, gyro integration and axis remap
with rssync_tpu's, on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rssync_tpu.frontend import integrate as jintegrate
from rssync_tpu.frontend import telemetry as jtelemetry
from rssync_tpu.ops import lens as jlens
from rssync_tpu_torch.frontend import integrate as tintegrate
from rssync_tpu_torch.frontend import telemetry as ttelemetry
from rssync_tpu_torch.ops import lens as tlens

torch.set_num_threads(2)

#: float32 lens math on O(1) normalized coordinates; the frameworks may
#: round tan/cos and fused products differently
ATOL = 1e-6
#: integration is f64 numpy on both sides, the same operations in order
INTEGRATE_ATOL = 1e-12

HERO = dict(ro=0.0111, fx=1186.0, fy=1190.0, cx=1355.2, cy=1020.7,
            k1=0.0444, k2=0.0195, k3=-0.00448, k4=-0.00204)


def _lenses(params):
    jl = jlens.Lens(**params)
    return jl, tlens.Lens.from_array(jl.as_array())


def _pixels(seed, width, height, cx, cy):
    """Pixels over a frame (and a little past it), with the raw-zero
    corner and the principal point."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-20.0, 1.0, size=(600, 2)) + rng.uniform(0.0, 1.0, size=(600, 2)) * (width, height)
    pts[0] = 0.0  # the reference's raw-pixel early-out
    pts[1] = [cx, cy]  # theta_d = 0
    return pts.astype(np.float32)


@pytest.mark.parametrize("params,size", [
    (HERO, (2704, 2028)),
    (dict(ro=0.01, fx=500.0, fy=500.0, cx=320.0, cy=240.0, k1=0.02), (640, 480)),
])
def test_undistort_and_rays_match_jax(params, size):
    jl, tl = _lenses(params)
    pts = _pixels(0, *size, params["cx"], params["cy"])
    want = np.asarray(jlens.undistort_points(jl, jnp.asarray(pts)))
    got = tlens.undistort_points(tl, torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.all(got[0] == 0.0)
    want_r = np.asarray(jlens.rays_from_normalized(jnp.asarray(want)))
    got_r = tlens.rays_from_normalized(torch.as_tensor(got)).numpy()
    np.testing.assert_allclose(got_r, want_r, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got_r, axis=-1), 1.0, atol=ATOL)


def test_undistort_safeguard_far_outside_matches_jax():
    """Points far past the frame take the halving guard; theta ends near
    pi/2, where tan magnifies float32 rounding, so the check is
    relative."""
    jl, tl = _lenses(HERO)
    pts = np.array([[-9000.0, 12000.0], [30000.0, 1020.0], [-5000.0, -5000.0]], np.float32)
    want = np.asarray(jlens.undistort_points(jl, jnp.asarray(pts)))
    got = tlens.undistort_points(tl, torch.as_tensor(pts)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_distort_inverts_undistort_and_matches_jax():
    jl, tl = _lenses(HERO)
    rng = np.random.default_rng(1)
    xy = rng.uniform(-1.2, 1.2, size=(300, 2)).astype(np.float32)
    xy[0] = 0.0
    want = np.asarray(jlens.distort_points(jl, jnp.asarray(xy)))
    got = tlens.distort_points(tl, torch.as_tensor(xy)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)  # pixels ~ 1e3
    back = tlens.undistort_points(tl, torch.as_tensor(got, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(back, xy, atol=ATOL)  # pixels rounded to float32


def test_lens_array_roundtrip():
    jl, tl = _lenses(HERO)
    np.testing.assert_array_equal(tl.as_array(), jl.as_array())
    assert tlens.Lens.from_array(tl.as_array()) == tl


@pytest.mark.parametrize("batch", [(), (3,)])
def test_integrate_gyro_matches_jax(batch):
    rng = np.random.default_rng(2)
    n = 1000
    ts = np.cumsum(rng.uniform(0.004, 0.006, size=n))
    gyro = rng.normal(scale=2.0, size=(*batch, n, 3))
    got = tintegrate.integrate_gyro(ts, gyro)
    np.testing.assert_allclose(got, jintegrate.integrate_gyro(ts, gyro), atol=INTEGRATE_ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-12)
    fixed = tintegrate.integrate_gyro_fixed_rate(gyro[..., :200, :].reshape(-1, 200, 3)[0], 200.0)
    np.testing.assert_allclose(
        fixed, jintegrate.integrate_gyro_fixed_rate(gyro[..., :200, :].reshape(-1, 200, 3)[0], 200.0),
        atol=INTEGRATE_ATOL, rtol=0)
    assert tintegrate.integrate_gyro(np.zeros(0), np.zeros((0, 3))).shape == (0, 4)


@pytest.mark.parametrize("orient", ["xyz", "XYZ", "yZx", "Zxy", None])
def test_apply_orientation_matches_jax(orient):
    g = np.random.default_rng(3).normal(size=(50, 3))
    np.testing.assert_array_equal(
        ttelemetry.apply_orientation(g, orient), jtelemetry.apply_orientation(g, orient))


def test_apply_orientation_rejects_bad_strings():
    for bad in ("xy", "abc", "xyzz"):
        with pytest.raises(ValueError, match="orientation"):
            ttelemetry.apply_orientation(np.zeros((2, 3)), bad)
